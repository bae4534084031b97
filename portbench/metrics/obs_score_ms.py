"""obs_score_ms: device milliseconds a step of the operations launched
inside the observation's and the score's range (``layer.obs_score``), but
not inside a reset, over the traced window's steps.

Layer: observation and score (``core/preproc.py``, ``tasks/*.py``
``score_fn``).  Moves env_steps_per_s."""

LAYER = 'observation and score'
UNIT = 'ms'
MOVES = 'env_steps_per_s'


def read(ctx):
    us = ctx.trace.device_us(('layer.obs_score',), ('portbench.reset',))
    if not us or not ctx.steps:
        return None
    return us / ctx.steps / 1e3
