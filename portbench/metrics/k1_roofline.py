"""k1_roofline: the least time one H100 could take for the control steps
of the counted states over the device time of the kernels launched in
those steps' control-step range, in percent.  The count is the benchmark's
own (``work/counts.py`` ``k1_work`` of the state before each counted step,
``bound``), so no kernel can move it.

Layer: physics K1.  Moves env_steps_per_s."""

from portbench.work import counts

LAYER = 'physics K1'
UNIT = '%'
MOVES = 'env_steps_per_s'


def read(ctx):
    per_step = ctx.trace.by_step('layer.k1')
    bound_ms = took_us = 0.0
    for step, pre, _ in ctx.work:
        if per_step.get(step):
            bound_ms += counts.bound(*counts.k1_work(pre))[0]
            took_us += per_step[step]
    if not took_us:
        return None
    return 100.0 * bound_ms * 1e3 / took_us
