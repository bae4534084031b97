"""render_ms: device milliseconds a step of the kernels launched inside
the ring render's range (``layer.render``: K2 at lo, K4 at hi), over the
traced window's steps.

Layer: render (``core/render_kernel.py`` -> ``csrc/render_lo.cu``,
``render_hi.cu``, ``render_tiles.cuh``).  Moves env_steps_per_s."""

LAYER = 'render'
UNIT = 'ms'
MOVES = 'env_steps_per_s'


def read(ctx):
    us = ctx.trace.device_us(('layer.render',))
    if not us or not ctx.steps:
        return None
    return us / ctx.steps / 1e3
