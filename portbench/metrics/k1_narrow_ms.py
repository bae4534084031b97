"""k1_narrow_ms: device milliseconds a step of the control step's
narrowphase: the device time a step of the operations launched inside the
port's K1 span (``magical.k1``), times the narrowphase's share of the
kernel's clock64() cycles over the traced window's steps
(``counters()['k1_cycles']``, counted by each env's warp per phase).

Layer: physics K1 (``core/physics_kernel.py`` -> ``csrc/physics_step.cuh``,
the slots and the narrowphase).  Moves env_steps_per_s.  A program
without the span or ``BatchedEnv.counters`` reads nothing."""

LAYER = 'physics K1'
UNIT = 'ms'
MOVES = 'env_steps_per_s'


def read(ctx):
    counters = getattr(ctx.env, 'counters', None)
    if not counters or not ctx.steps:
        return None
    cycles = counters()['k1_cycles']
    total = sum(cycles.values())
    us = ctx.trace.device_us(('magical.k1',))
    if not us or not total:
        return None
    return us / ctx.steps / 1e3 * cycles['narrowphase'] / total
