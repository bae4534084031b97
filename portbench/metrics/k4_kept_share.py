"""k4_kept_share: the share of the active display prims that the hi
render's tile cull keeps, in percent: over every block (an env's tile of
32 x 32 output pixels) and the traced window's steps, the active prims
from slot 2 up whose screen box meets the tile's subpixels, over the
active prims from slot 2 up (``counters()['k4_items']``, counted by each
block; slots 0 and 1, the arena's fill and border, are kept by every block
and in neither).

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
    items = counters().get('k4_items')
    if not items or not items['active']:
        return None
    return 100.0 * items['kept'] / items['active']
