"""step_host_ms: the host's milliseconds of one ``BatchedEnv.step`` call
made on an idle card (synchronised before, not after): the cost of
enqueueing a step, the mean over the traced run's unprofiled steps.

Layer: API step dispatch (``api/batched_env.py`` ``BatchedEnv.step``).
Moves env_steps_per_s where the card waits for the host."""

import statistics

LAYER = 'API step dispatch'
UNIT = 'ms'
MOVES = 'env_steps_per_s'


def read(ctx):
    if not ctx.host_step_s:
        return None
    return statistics.mean(ctx.host_step_s) * 1e3
