"""render_roofline: the least time one H100 could take for the frames of
every view of the counted states over the device time of the kernels
launched in those steps' ring-render range, in percent.  The count is the
benchmark's own (``work/counts.py`` ``render_work`` of the state after
each counted step, from the frozen reference's display list, ``bound``).

Layer: render.  Moves env_steps_per_s."""

from portbench.work import counts

LAYER = 'render'
UNIT = '%'
MOVES = 'env_steps_per_s'


def read(ctx):
    per_step = ctx.trace.by_step('layer.render')
    env = ctx.env
    args = (env.task.max_blocks, env.task.max_goals, env.robot_first)
    spec = env.preproc
    bound_ms = took_us = 0.0
    for step, _, post in ctx.work:
        if not per_step.get(step):
            continue
        disp = counts.display(post, *args, env.static_shapes)
        for view in spec.views:
            ops, nbytes, _ = counts.render_work(disp, post, view, spec.res,
                                                ctx.fidelity)
            bound_ms += counts.bound(ops, nbytes)[0]
        took_us += per_step[step]
    if not took_us:
        return None
    return 100.0 * bound_ms * 1e3 / took_us
