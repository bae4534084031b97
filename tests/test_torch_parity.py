"""magical_tpu_torch.data.parity, the reference-parity reset sampler,
against magical_tpu.data.parity: the same scene specs (the same float64
numpy, compared exactly) for every family and variant, the same draws in
the same order through a recording RandomState, and `state_from_spec`
against core/convert of JAX's on the same specs."""

import dataclasses

import numpy as np
import pytest
import torch

from magical_tpu.data import parity as JPar
from magical_tpu.tasks import ALL_TASKS as JAX_TASKS
from magical_tpu_torch.core import physics as TP
from magical_tpu_torch.data import parity as TPar
from magical_tpu_torch.tasks import ALL_TASKS

from _torch_port import RESET_POSE_ATOL, jax_to_numpy, torch_to_numpy

TASKS = tuple(TPar.SAMPLERS)
SEEDS = (0, 1, 2)


def test_the_same_samplers():
    assert tuple(TPar.SAMPLERS) == tuple(JPar.SAMPLERS)
    assert set(TASKS) == set(ALL_TASKS)


def assert_specs_equal(a, b):
    """Two SceneSpecs, field by field, exactly."""
    assert a.robot_pose == b.robot_pose
    for f in ('block_shapes', 'block_colours', 'goal_colours'):
        assert [int(x) for x in getattr(a, f)] == \
            [int(x) for x in getattr(b, f)], f
    assert a.block_poses == b.block_poses
    assert a.goal_cxcyhw == b.goal_cxcyhw
    assert a.phys.dtype == b.phys.dtype
    np.testing.assert_array_equal(a.phys, b.phys)


@pytest.mark.parametrize('variant', ['Demo', 'TestAll'])
@pytest.mark.parametrize('task', TASKS)
def test_specs_equal_the_jax_packages(task, variant):
    flags = ALL_TASKS[task].flags_for(variant)
    assert dataclasses.asdict(flags) == dataclasses.asdict(
        JAX_TASKS[task].flags_for(variant))
    for seed in SEEDS:
        assert_specs_equal(TPar.sample_scene(task, seed, flags),
                           JPar.sample_scene(task, seed, flags))


# ---------------------------------------------------------------------------
# The draw order, through a recording RandomState on both sides
# ---------------------------------------------------------------------------

class RecordingRng:
    """np.random.RandomState behind the sampler's rng interface, logging
    every call with its bounds and its result."""

    def __init__(self, seed):
        self._rng = np.random.RandomState(seed)
        self.calls = []

    def uniform(self, low=0.0, high=1.0, size=None):
        out = self._rng.uniform(low, high, size)
        self.calls.append(('uniform', float(low), float(high), size,
                           np.asarray(out).tolist()))
        return out

    def randint(self, low, high=None, size=None):
        out = self._rng.randint(low, high, size)
        self.calls.append(('randint', int(low), high, size,
                           np.asarray(out).tolist()))
        return out

    def choice(self, values, size=None):
        idx = self._rng.randint(0, len(values), size)
        self.calls.append(('choice', len(values), size,
                           np.asarray(idx).tolist()))
        if size is None:
            return values[int(idx)]
        return [values[int(i)] for i in np.asarray(idx).ravel()]

    def shuffle(self, lst):
        idx = np.arange(len(lst))
        self._rng.shuffle(idx)
        self.calls.append(('shuffle', len(lst), idx.tolist()))
        lst[:] = [lst[i] for i in idx]


def record(module, task, flags, seed):
    """(calls, placements, spec) of `module`'s sampler on a recording rng:
    every draw, and each placement's limits and obstacle count."""
    rng = RecordingRng(seed)
    placements = []
    orig = module._Placer.randomise_pose

    def patched(self, make_entity, cur_pos, cur_angle, rand_pos=True,
                rand_rot=True, pos_linf=None, rot_limit=None, ignore=None):
        ignore = ignore or []
        placements.append((tuple(cur_pos), cur_angle, rand_rot, pos_linf,
                           rot_limit, len(self.obstacles), len(ignore),
                           len(rng.calls)))
        return orig(self, make_entity, cur_pos, cur_angle, rand_pos=rand_pos,
                    rand_rot=rand_rot, pos_linf=pos_linf,
                    rot_limit=rot_limit, ignore=ignore)

    module._Placer.randomise_pose = patched
    try:
        spec = module.SAMPLERS[task](rng, flags)
    finally:
        module._Placer.randomise_pose = orig
    return rng.calls, placements, spec


@pytest.mark.parametrize('variant', ['TestAll', 'TestJitter', 'TestLayout',
                                     'TestCountPlus'])
@pytest.mark.parametrize('task', TASKS)
def test_draw_order_equals_the_jax_packages(task, variant):
    if variant not in ALL_TASKS[task].variants:
        variant = 'TestAll'
    flags = ALL_TASKS[task].flags_for(variant)
    for seed in (4, 5):
        tc, tp, ts = record(TPar, task, flags, seed)
        jc, jp, js = record(JPar, task, flags, seed)
        assert tc == jc
        assert tp == jp
        assert_specs_equal(ts, js)
    if flags.layout_minor or flags.layout_full:
        assert tp, (task, variant)


# ---------------------------------------------------------------------------
# state_from_spec
# ---------------------------------------------------------------------------

INT_FIELDS = ('block_shape', 'block_colour', 'block_active', 'con_id', 'aux',
              'place_fail', 't')
FLOAT_FIELDS = ('pos', 'angle', 'vel', 'omega', 'v_bias', 'w_bias',
                'target_speed', 'rel_turn_angle', 'target_finger_angle',
                'con_jn', 'con_jt', 'joint_acc', 'phys')


@pytest.mark.parametrize('variant', ['Demo', 'TestAll'])
@pytest.mark.parametrize('task', TASKS)
def test_state_from_spec_equals_the_jax_packages(task, variant):
    """One batch of the specs of seeds 0..3 against JAX's state_from_spec
    of each spec: poses within RESET_POSE_ATOL, the rest exactly.  JAX's
    goal arrays hold only the spec's goals; the port's hold max_goals rows,
    the rest inactive."""
    t = ALL_TASKS[task]
    flags = t.flags_for(variant)
    specs = [TPar.sample_scene(task, s, flags) for s in range(4)]
    ts = torch_to_numpy(TPar.state_from_spec(specs, t.max_blocks,
                                             t.max_goals, device='cpu'))
    for e, spec in enumerate(specs):
        jn = jax_to_numpy(JPar.state_from_spec(spec, t.max_blocks,
                                               t.max_goals))
        for f in FLOAT_FIELDS:
            np.testing.assert_allclose(ts[f][e], jn[f], rtol=0,
                                       atol=RESET_POSE_ATOL, err_msg=f)
        for f in INT_FIELDS:
            np.testing.assert_array_equal(ts[f][e], jn[f], err_msg=f)
        k = len(spec.goal_cxcyhw)
        np.testing.assert_allclose(ts['goal_xyhw'][e][:k],
                                   jn['goal_xyhw'][:k], rtol=0,
                                   atol=RESET_POSE_ATOL)
        if k:
            np.testing.assert_array_equal(ts['goal_colour'][e][:k],
                                          jn['goal_colour'])
            assert ts['goal_active'][e][:k].all() and jn['goal_active'].all()
        assert not ts['goal_active'][e][k:].any()
        assert not ts['goal_xyhw'][e][k:].any()


def test_state_from_spec_takes_one_spec():
    t = ALL_TASKS['MoveToCorner']
    spec = TPar.sample_scene('MoveToCorner', 7, t.flags_for('Demo'))
    st = TPar.state_from_spec(spec, t.max_blocks, t.max_goals, device='cpu')
    assert st.batch == 1 and st.device.type == 'cpu'
    np.testing.assert_allclose(st.pos[0, 0].numpy(), (0.4, 0.0), atol=1e-7)


def test_state_from_spec_runs_on_the_card_by_default():
    t = ALL_TASKS['MoveToCorner']
    spec = TPar.sample_scene('MoveToCorner', 7, t.flags_for('Demo'))
    if torch.cuda.is_available():
        assert TPar.state_from_spec(spec, 1, 0).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            TPar.state_from_spec(spec, t.max_blocks, t.max_goals)


@pytest.mark.parametrize('task', TASKS)
def test_spec_states_step_deterministically(task):
    """One batch of Demo and TestAll spec states (seeds 13 and 14) through
    3 plain control steps: finite, scores in [0, 1], and the first step
    the same on a second run."""
    t = ALL_TASKS[task]
    specs = [TPar.sample_scene(task, s, t.flags_for(variant))
             for variant in ('Demo', 'TestAll') for s in (13, 14)]
    st = TPar.state_from_spec(specs, t.max_blocks, t.max_goals, device='cpu')
    act = torch.full((len(specs),), 4, dtype=torch.int32)
    first = TP.control_step(st.clone(), act)
    s = first
    for _ in range(2):
        s = TP.control_step(s, act)
    assert torch.isfinite(s.pos).all(), task
    assert torch.equal(TP.control_step(st.clone(), act).pos, first.pos)
    score = t.score_fn(s)
    assert ((score >= 0) & (score <= 1)).all(), task
