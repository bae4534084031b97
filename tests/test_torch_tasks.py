"""The six multi-block task families of magical_tpu_torch (FixColour,
MakeLine, FindDupe, MatchRegions, ClusterColour, ClusterShape) against
magical_tpu's: task tables, the Demo and TestJitter resets, and the
hand-made score cases.

The Demo resets draw nothing but their defaults, so the port's equals
JAX's field by field.  The Test resets are held on the same random
numbers: the uniforms and integers that JAX's reset draws from each key
(``_torch_port.jax_draws``) are handed to the port's reset through
``GivenDraws``.  (TestAll resets and scores on identical states:
tests/test_torch_tasks_testall.py; reset distributions:
tests/test_torch_tasks_ks.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magical_tpu import constants as JC
from magical_tpu.tasks import ALL_TASKS as JT
from magical_tpu_torch.core.state import N_ROBOT_BODIES
from magical_tpu_torch.tasks import ALL_TASKS as TT
from magical_tpu_torch.tasks import REGISTRATION_ORDER
from magical_tpu_torch.tasks.base import GivenDraws

from _torch_port import (FAMILIES, assert_resets_equal, jax_draws,
                         jax_resets, jax_to_numpy, jax_to_torch,
                         torch_to_numpy)

B = 8
NB = N_ROBOT_BODIES


def _keys(n=B, seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _jax_resets(task, variant, n=B):
    return jax_resets(task, variant, n)


def test_all_eight_families_in_registration_order():
    assert REGISTRATION_ORDER == tuple(JT)
    assert set(TT) == set(JT)


@pytest.mark.parametrize('task', FAMILIES)
def test_task_tables_match(task):
    j, t = JT[task], TT[task]
    assert (t.max_blocks, t.max_goals, t.ep_len, t.variants) == \
        (j.max_blocks, j.max_goals, j.ep_len, j.variants)
    for v in j.variants:
        jf, tf = j.flags_for(v), t.flags_for(v)
        assert (jf.colour, jf.shape, jf.count, jf.layout_minor,
                jf.layout_full, jf.dynamics) == (
            tf.colour, tf.shape, tf.count, tf.layout_minor, tf.layout_full,
            tf.dynamics), v
        assert t.static_block_shapes(tf) == j.static_block_shapes(jf), v
        assert t.reachable_shape_types(tf) == j.reachable_shape_types(jf), v


@pytest.mark.parametrize('task', FAMILIES)
def test_demo_reset_equals_the_reference(task):
    t = TT[task]
    st = t.reset_fn(torch.Generator().manual_seed(0), B, t.flags_for('Demo'),
                    'cpu')
    assert_resets_equal(st, jax_to_numpy(_jax_resets(task, 'Demo')))
    assert st.max_blocks == JT[task].max_blocks


@pytest.mark.parametrize('task', FAMILIES)
def test_jitter_reset_on_the_references_draws(task):
    """TestJitter: the jitter branch of each placement."""
    variant = 'TestJitter'
    t = TT[task]
    draws = jax_draws(task, variant, _keys())
    st = t.reset_from_draws(GivenDraws(draws, B, 'cpu'), t.flags_for(variant))
    jn = jax_to_numpy(_jax_resets(task, variant))
    assert_resets_equal(st, jn)
    # the draws did reach the layout: the poses moved from the defaults
    demo = jax_to_numpy(_jax_resets(task, 'Demo'))
    assert np.abs(jn['pos'][:, 0] - demo['pos'][:, 0]).max() > 1e-3


def test_given_draws_refuse_the_wrong_shape():
    draws = jax_draws('MakeLine', 'TestAll', _keys())
    draws['colours'] = draws['colours'][:, :3]
    with pytest.raises(ValueError, match='colours'):
        TT['MakeLine'].reset_from_draws(GivenDraws(draws, B, 'cpu'),
                                        TT['MakeLine'].flags_for('TestAll'))


# ---------------------------------------------------------------------------
# Hand-made score cases
# ---------------------------------------------------------------------------

def _demo(task):
    return jax_to_torch(_jax_resets(task, 'Demo', 1))


def _score(task, st):
    """The port's score of the one-env state `st`, asserted equal to the
    reference's `score_fn` on the same state."""
    ref = _jax_resets(task, 'Demo', 1)
    js = ref.replace(**{k: jnp.asarray(v)
                        for k, v in torch_to_numpy(st).items()})
    want = float(jax.vmap(JT[task].score_fn)(js)[0])
    got = float(TT[task].score_fn(st)[0])
    assert got == want
    return got


# The hand-made cases of tests/test_tasks.py, built in the port and scored
# by both packages; the constants are those of tests/test_tasks.py.

def test_hand_made_scores_match_regions():
    s = _demo('MatchRegions')
    goal = s.goal_xyhw[0, 0, :2].clone()
    assert _score('MatchRegions', s) == 0.0
    for slot in (0, 1):
        s.pos[0, NB + slot] = goal + slot * 0.05
    assert _score('MatchRegions', s) == 1.0
    s.pos[0, NB + 4] = goal                      # a distractor: 2/3 targets
    assert _score('MatchRegions', s) == pytest.approx(1.0 * (1 - 1 / 3))


def test_hand_made_scores_find_dupe():
    s = _demo('FindDupe')
    goal = s.goal_xyhw[0, 0, :2].clone()
    assert _score('FindDupe', s) == 0.0          # the query alone
    s.pos[0, NB + 5] = goal                      # its duplicate
    assert _score('FindDupe', s) == 1.0
    s.pos[0, NB + 0] = goal + 0.05               # a non-match: 1/3 off
    assert _score('FindDupe', s) == pytest.approx(1 - 1 / 3)


def test_hand_made_scores_fix_colour():
    s = _demo('FixColour')
    assert _score('FixColour', s) == 0.0         # blue block in the red one
    s.pos[0, NB + 2] = torch.tensor([0.9, -0.9])
    assert _score('FixColour', s) == 1.0


def test_hand_made_scores_make_line():
    s = _demo('MakeLine')
    line = np.stack([np.linspace(-0.6, 0.6, 4), np.zeros(4)], -1)
    s.pos[0, NB:] = torch.tensor(line, dtype=torch.float32)
    assert _score('MakeLine', s) == 1.0
    off = line.copy()
    off[3] = (0.0, 0.8)                          # one outlier
    s.pos[0, NB:] = torch.tensor(off, dtype=torch.float32)
    assert _score('MakeLine', s) == 0.5
    gap = line.copy()
    gap[3] = (3.5 * JC.SHAPE_RAD * 3, 0.0)       # a gap past the separation
    s.pos[0, NB:] = torch.tensor(gap, dtype=torch.float32)
    assert _score('MakeLine', s) == 0.5


def test_make_line_ties_and_inactive_slots():
    """longest_line at exact ties of the separation and the inlier
    distance, and with inactive slots anywhere, against the reference."""
    from magical_tpu.tasks import make_line as JML
    from magical_tpu_torch.tasks import make_line as TML
    sep, inl = JML.MAX_SEP, JML.INLIER_DIST
    pts = np.array([
        [[0, 0], [sep, 0], [2 * sep, 0], [3 * sep, 0]],
        [[0, 0], [sep, 0], [2 * sep, inl], [9, 9]],
        [[0, 0], [0, 0], [0, 0], [0, 0]],
        [[0, 0], [2 * sep, 0], [sep, 0], [5, 5]],
        [[0.1, 0.2], [0.3, 0.1], [-0.2, 0.5], [0.7, -0.4]],
        [[0, 0], [sep * 1.0001, 0], [0, sep], [0, 2 * sep]],
    ], np.float32)
    act = np.array([[1, 1, 1, 1], [1, 1, 1, 0], [1, 1, 0, 0], [0, 1, 1, 1],
                    [1, 0, 1, 0], [1, 1, 1, 1]], bool)
    want = np.asarray(jax.vmap(JML.longest_line)(jnp.asarray(pts),
                                                 jnp.asarray(act)))
    got = TML.longest_line(torch.from_numpy(pts), torch.from_numpy(act))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('task', ['ClusterColour', 'ClusterShape'])
def test_hand_made_scores_cluster(task):
    s = _demo(task)
    assert _score(task, s) < 0.5
    key = (s.block_colour if task == 'ClusterColour' else s.block_shape)[0]
    seen = {}
    for i, c in enumerate(key.tolist()):
        k = seen.get(c, 0)
        seen[c] = k + 1
        ang = 2 * np.pi * c / 7
        s.pos[0, NB + i] = torch.tensor([0.7 * np.cos(ang) + 0.02 * k,
                                         0.7 * np.sin(ang)])
    assert _score(task, s) == 1.0
