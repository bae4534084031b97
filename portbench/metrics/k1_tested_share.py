"""k1_tested_share: the share of K1's narrowphase items that its
broadphase cull leaves for the full contact test, in percent: items tested
in full over the items of active slots, summed over substeps, envs and the
traced window's steps (``counters()['k1_items']``, counted by each env's
warp).

Layer: physics K1 (``core/physics_kernel.py`` -> ``csrc/physics_step.cuh``,
the narrowphase).  Moves env_steps_per_s.  A program without the counter
reads nothing."""

LAYER = 'physics K1'
UNIT = '%'
MOVES = 'env_steps_per_s'


def read(ctx):
    counters = getattr(ctx.env, 'counters', None)
    if not counters:
        return None
    items = counters().get('k1_items')
    if not items or not items['candidates']:
        return None
    return 100.0 * items['tested'] / items['candidates']
