"""k4_undecided_share: the share of the hi render's output pixels that K4
shades per subpixel, in percent: over every block (an env's tile of 32 x
32 output pixels) and the traced window's steps, the pixels left undecided
by their classes (a prim partial over its 16 subpixels above the topmost
full one), over every pixel (``counters()['k4_pixels']``, counted by each
block).

Layer: render (``core/render_kernel.py`` -> ``csrc/render_hi.cu``,
``render_tiles.cuh``).  Moves env_steps_per_s.  A program without the
counter reads nothing."""

LAYER = 'render'
UNIT = '%'
MOVES = 'env_steps_per_s'


def read(ctx):
    counters = getattr(ctx.env, 'counters', None)
    if not counters:
        return None
    pixels = counters().get('k4_pixels')
    if not pixels or not pixels['pixels']:
        return None
    return 100.0 * pixels['undecided'] / pixels['pixels']
