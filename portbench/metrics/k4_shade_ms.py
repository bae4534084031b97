"""k4_shade_ms: device milliseconds a step of the hi render's shading: the
device time a step of the operations launched inside the port's render
span (``magical.render``: K4 at hi), times the shading's share of K4's
clock64() cycles over the traced window's steps
(``counters()['k4_cycles']``, counted by each block's thread 0, building
and culling the prims against shading the tile).

Layer: render (``core/render_kernel.py`` -> ``csrc/render_hi.cu``,
``render_tiles.cuh``).  Moves env_steps_per_s.  A program without the span
or the counter reads nothing."""

LAYER = 'render'
UNIT = 'ms'
MOVES = 'env_steps_per_s'


def read(ctx):
    counters = getattr(ctx.env, 'counters', None)
    if not counters or not ctx.steps:
        return None
    cycles = counters().get('k4_cycles')
    if not cycles:
        return None
    total = sum(cycles.values())
    us = ctx.trace.device_us(('magical.render',))
    if not us or not total:
        return None
    return us / ctx.steps / 1e3 * cycles['shade'] / total
