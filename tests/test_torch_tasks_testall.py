"""The six multi-block task families of magical_tpu_torch against
magical_tpu's on their TestAll variants (every randomisation: colours,
shapes, counts, full layout and dynamics): resets on the reference's own
random numbers, and scores on identical states, which must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from magical_tpu.tasks import ALL_TASKS as JT
from magical_tpu_torch.core.state import N_ROBOT_BODIES
from magical_tpu_torch.tasks import ALL_TASKS as TT
from magical_tpu_torch.tasks.base import GivenDraws

from _torch_port import (FAMILIES, assert_resets_equal, jax_draws,
                         jax_resets, jax_to_numpy, jax_to_torch)

B = 8
NB = N_ROBOT_BODIES


def _keys():
    return jax.random.split(jax.random.PRNGKey(0), B)


def _jax_resets(task, variant):
    return jax_resets(task, variant, B)


@pytest.mark.parametrize('task', FAMILIES)
def test_testall_reset_on_the_references_draws(task):
    variant = 'TestAll'
    t = TT[task]
    draws = jax_draws(task, variant, _keys())
    st = t.reset_from_draws(GivenDraws(draws, B, 'cpu'), t.flags_for(variant))
    jn = jax_to_numpy(_jax_resets(task, variant))
    assert_resets_equal(st, jn)
    # the draws did reach the layout: the poses moved from the defaults
    demo = jax_to_numpy(_jax_resets(task, 'Demo'))
    assert np.abs(jn['pos'][:, 0] - demo['pos'][:, 0]).max() > 1e-3


# ---------------------------------------------------------------------------
# Scores on identical states
# ---------------------------------------------------------------------------

def _scored_states(task, seed):
    """B JAX TestAll reset states with the blocks moved where the score
    takes its values: into the goal regions, along a line, or into
    clusters, each with noise, and some envs at random."""
    st = _jax_resets(task, 'TestAll')
    rng = np.random.default_rng(seed)
    pos = np.array(st.pos)
    act = np.asarray(st.block_active)
    mb = act.shape[1]
    for b in range(B):
        if b % 4 == 3:                                  # at random
            pos[b, NB:] = rng.uniform(-0.9, 0.9, (mb, 2))
            continue
        if task == 'MakeLine':
            d = rng.normal(size=2)
            d /= np.linalg.norm(d)
            t = np.cumsum(rng.uniform(0.08, 0.35, mb)) - 0.5
            pos[b, NB:] = rng.uniform(-0.3, 0.3, 2) + t[:, None] * d \
                + rng.normal(0.0, 0.03, (mb, 2))
        elif task.startswith('Cluster'):
            key = np.asarray(st.block_colour if task == 'ClusterColour'
                             else st.block_shape)[b]
            centres = rng.uniform(-0.8, 0.8, (8, 2))
            pos[b, NB:] = centres[key] + rng.normal(0.0, 0.08, (mb, 2))
        else:
            goals = np.asarray(st.goal_xyhw)[b]
            for i in range(mb):
                g = goals[i % len(goals)] if task == 'FixColour' else goals[0]
                inside = rng.random() < 0.6
                pos[b, NB + i] = (g[:2] + rng.uniform(-0.45, 0.45, 2)
                                  * g[[3, 2]]) if inside else \
                    rng.uniform(-0.9, 0.9, 2)
    return st.replace(pos=jnp.asarray(pos, jnp.float32))


@pytest.mark.parametrize('task', FAMILIES)
def test_score_equals_the_reference(task):
    score_j = jax.jit(jax.vmap(JT[task].score_fn))
    values = set()
    for js in (_jax_resets(task, 'Demo'), _jax_resets(task, 'TestAll'),
               _scored_states(task, 1), _scored_states(task, 2)):
        want = np.asarray(score_j(js))
        got = TT[task].score_fn(jax_to_torch(js)).numpy()
        np.testing.assert_array_equal(got, want)
        values |= set(want.tolist())
    assert len(values) >= 2, values


