"""reset_ms: the host's milliseconds of a reset, synchronised before and
after (the traced run's unprofiled episodes), the mean over them.

Layer: reset and placement (``tasks/*.py``, ``tasks/randomize.py``, through
``BatchedEnv.reset``: the host's draws, the placement, the copies to the
card and the first frames).  Moves env_steps_per_s: every episode pays
one reset inside the window."""

import statistics

LAYER = 'reset and placement'
UNIT = 'ms'
MOVES = 'env_steps_per_s'


def read(ctx):
    if not ctx.host_reset_s:
        return None
    return statistics.mean(ctx.host_reset_s) * 1e3
