"""magical_tpu_torch's plain control step against magical_tpu's XLA
reference at the block counts of the multi-block families (FixColour 3,
MakeLine 4, FindDupe 7; MatchRegions 8 and the Cluster families 10 in
tests/test_torch_tasks_physics_wide.py), from converted JAX Demo and
TestAll states, after one step and after five."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from magical_tpu.core import physics as JP
from magical_tpu_torch.core import physics as TP

from _torch_port import (jax_resets, jax_to_numpy, jax_to_torch, max_abs,
                         nudges, torch_actions, torch_to_numpy)
from test_torch_physics import FIELDS, ONE_STEP_ATOL

B = 4
_step = jax.jit(jax.vmap(JP.control_step))


@functools.lru_cache(maxsize=None)
def _actions(n_steps, seed):
    return np.random.default_rng(seed).integers(0, 18, (n_steps, B)) \
        .astype(np.int32)


def _start(task, variant):
    """JAX start states: the reset after one settling step.  The first
    control step from these families' resets is chaotic in the reference
    itself, Demo poses included (a 1-ulp nudge of the MatchRegions Demo
    positions moves them by 4.5e-4 in that step): ROADMAP.md, "Faults
    found"."""
    return _step(jax_resets(task, variant, B),
                 jnp.asarray(_actions(1, 7)[0]))


def check_physics(task, variant):
    """One and five control steps of the port from a converted JAX state,
    held to the one-step tolerance of tests/test_torch_physics.py or to
    twice the reference's own divergence under a 1-ulp nudge of every
    position or angle, whichever is larger (MatchRegions' Demo fingers are
    chaotic in the reference even after the settling step)."""
    js = _start(task, variant)
    acts = _actions(5, 3)
    for n_steps in (1, 5):
        ts, jr, nudged = jax_to_torch(js), js, nudges(js)
        for a in acts[:n_steps]:
            ts = TP.control_step(ts, torch_actions(a))
            jr = _step(jr, jnp.asarray(a))
            nudged = [_step(jc, jnp.asarray(a)) for jc in nudged]
        jn, tn = jax_to_numpy(jr), torch_to_numpy(ts)
        cns = [jax_to_numpy(jc) for jc in nudged]
        for f in FIELDS:
            chaos = max(max_abs(cn[f], jn[f]) for cn in cns)
            tol = max(ONE_STEP_ATOL[f], 2.0 * chaos)
            assert max_abs(tn[f], jn[f]) <= tol, (n_steps, f)
        np.testing.assert_array_equal(tn['t'], jn['t'])


@pytest.mark.parametrize('task', ['FixColour', 'MakeLine', 'FindDupe'])
@pytest.mark.parametrize('variant', ['Demo', 'TestAll'])
def test_control_step_matches_the_reference(task, variant):
    check_physics(task, variant)
