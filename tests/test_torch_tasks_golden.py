"""The multi-block families' Demo variants in magical_tpu_torch against
the JAX package's own CPU numbers in tests/fixtures/golden_trajectories.npz
(scripts/gen_golden_fixtures.py: reset, 40 scripted control steps through
the XLA physics, the score at the end): the reset pose, the first
snapshot (after step 1) and the final score.

The first step from these Demo poses is chaotic in the reference itself
(ROADMAP.md, "Faults found"), so the first snapshot is held to the
one-step tolerance of tests/test_torch_physics.py or twice the
reference's own divergence under a 1-ulp nudge of every position or
angle, whichever is larger."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magical_tpu.core import physics as JP
from magical_tpu_torch.core import physics
from magical_tpu_torch.tasks import ALL_TASKS

from _torch_port import FAMILIES, jax_resets, max_abs, nudges, torch_actions
from test_golden_trajectories import N_STEPS, SCRIPT
from test_torch_physics import ONE_STEP_ATOL

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'fixtures', 'golden_trajectories.npz')
B = 2


@pytest.mark.parametrize('task_name', FAMILIES)
def test_golden_trajectory_of_the_demo(task_name):
    fix = np.load(FIXTURE)
    key = f'{task_name}-Demo'
    task = ALL_TASKS[task_name]
    st = task.reset_fn(torch.Generator().manual_seed(0), B,
                       task.flags_for('Demo'), 'cpu')
    np.testing.assert_allclose(st.pos.numpy(), fix[f'{key}/reset_pos'],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.angle.numpy(), fix[f'{key}/reset_angle'],
                               rtol=0, atol=1e-6)
    # the reference's own divergence in its first step
    js = jax_resets(task_name, 'Demo', B)
    a0 = jnp.full((B,), SCRIPT[0], jnp.int32)
    step = jax.jit(jax.vmap(JP.control_step))
    nudged = [step(n, a0) for n in nudges(js)]
    for t in range(N_STEPS):
        a = torch_actions([SCRIPT[t % len(SCRIPT)]] * B)
        st = physics.control_step(st, a)
        if t == 0:
            for f in ('pos', 'angle'):
                want = fix[f'{key}/{f}'][0]
                chaos = max(max_abs(getattr(n, f), want) for n in nudged)
                tol = max(ONE_STEP_ATOL[f], 2.0 * chaos)
                assert max_abs(getattr(st, f).numpy(), want) <= tol, f
    np.testing.assert_array_equal(task.score_fn(st).numpy(),
                                  fix[f'{key}/score'])
