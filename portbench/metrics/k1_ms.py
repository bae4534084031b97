"""k1_ms: device milliseconds a step of the kernels launched inside the
control step's range (``layer.k1``), over the traced window's steps.

Layer: physics K1 (``core/physics_kernel.py`` -> ``csrc/physics_step*.cu``).
Moves env_steps_per_s."""

LAYER = 'physics K1'
UNIT = 'ms'
MOVES = 'env_steps_per_s'


def read(ctx):
    us = ctx.trace.device_us(('layer.k1',))
    if not us or not ctx.steps:
        return None
    return us / ctx.steps / 1e3
