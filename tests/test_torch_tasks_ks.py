"""The six multi-block task families' Test resets, magical_tpu_torch against
magical_tpu, in distribution.

Whole resets draw from different generators (threefry and torch's), so
they are held as tests/test_reset_ks.py holds the JAX package's two
samplers: a two-sample KS test on each continuous marginal and pooled
proportion bounds on each discrete one, over N resets of TestAll and of
TestCountPlus.  (The same resets on the same random numbers:
tests/test_torch_tasks.py.)

A reset at N = 256 takes the port's plain placement tens of seconds on
one CPU thread for the wider families, so the cases are spread over this
file and test_torch_tasks_ks_*.py, a file or two cases each.
"""

import numpy as np
import pytest
import torch

from magical_tpu_torch.core.state import N_ROBOT_BODIES
from magical_tpu_torch.tasks import ALL_TASKS as TT

from _torch_port import RESET_FIELDS, jax_resets
from test_reset_ks import ks_2samp, prop_diff_ok

N = 256
KS_P_MIN = 1e-3
NB = N_ROBOT_BODIES


def check_reset_distributions(task, variant):
    js = jax_resets(task, variant, N)
    j = {f: np.asarray(getattr(js, f)) for f in RESET_FIELDS}
    t = TT[task]
    ts = t.reset_fn(torch.Generator().manual_seed(0), N,
                    t.flags_for(variant), 'cpu')
    p = {f: getattr(ts, f).numpy() for f in RESET_FIELDS}
    failures = []

    def ks(name, a, b):
        a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
        if a.std() < 1e-9 and b.std() < 1e-9:
            if abs(a.mean() - b.mean()) > 1e-6:
                failures.append((name, 'const', a.mean(), b.mean()))
            return
        d, pv = ks_2samp(a, b)
        if pv < KS_P_MIN:
            failures.append((name, 'ks', d, pv))

    def prop(name, a, b):
        bad = prop_diff_ok(a, b, np.unique(np.concatenate([a, b])))
        if bad:
            failures.append((name, 'prop', bad))

    ks('robot_x', j['pos'][:, 0, 0], p['pos'][:, 0, 0])
    ks('robot_y', j['pos'][:, 0, 1], p['pos'][:, 0, 1])
    ks('robot_cos', np.cos(j['angle'][:, 0]), np.cos(p['angle'][:, 0]))
    ks('robot_sin', np.sin(j['angle'][:, 0]), np.sin(p['angle'][:, 0]))
    # the block count, and each block slot's activity
    prop('n_blocks', j['block_active'].sum(1), p['block_active'].sum(1))
    for k in range(t.max_blocks):
        prop(f'active_{k}', j['block_active'][:, k], p['block_active'][:, k])
    # every active block's pose, shape and colour, pooled over the slots
    ja, pa = j['block_active'], p['block_active']
    for nm, f, i in (('block_x', 'pos', 0), ('block_y', 'pos', 1)):
        ks(nm, j[f][:, NB:, i][ja], p[f][:, NB:, i][pa])
    ks('block_cos', np.cos(j['angle'][:, NB:][ja]),
       np.cos(p['angle'][:, NB:][pa]))
    prop('block_shape', j['block_shape'][ja], p['block_shape'][pa])
    prop('block_colour', j['block_colour'][ja], p['block_colour'][pa])
    # the goals: count, pose, size and colour of the active ones
    jg, pg = j['goal_active'], p['goal_active']
    prop('n_goals', jg.sum(1), pg.sum(1))
    if jg.any():
        for i, nm in enumerate(('goal_x', 'goal_y', 'goal_h', 'goal_w')):
            ks(nm, j['goal_xyhw'][..., i][jg], p['goal_xyhw'][..., i][pg])
        prop('goal_colour', j['goal_colour'][jg], p['goal_colour'][pg])
    for i in range(j['phys'].shape[1]):
        ks(f'phys_{i}', j['phys'][:, i], p['phys'][:, i])
    prop('place_fail', j['place_fail'] > 0, p['place_fail'] > 0)
    assert not failures, failures


VARIANTS = ('TestAll', 'TestCountPlus')


@pytest.mark.parametrize('task', ['FixColour', 'MakeLine'])
@pytest.mark.parametrize('variant', VARIANTS)
def test_reset_distributions_match(task, variant):
    check_reset_distributions(task, variant)
