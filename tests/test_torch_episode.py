"""The whole-episode hold of magical_tpu_torch's physics against the
reference: tests/fixtures/torch_episode_reference.npz holds magical_tpu's
XLA episodes of three legs (MoveToCorner, mb 1, 80 steps; MatchRegions, mb
8, 120; ClusterColour, mb 10, 240), each 64 Demo resets from PRNGKey(0)
driven by 64 distinct action sequences (env 0 scripts/chaos_floor.py's
script, envs 1-63 held actions drawn from a stated seed), written by
tests/_torch_episode_fixture.py.

The bound is the reference's own 1-ulp self-divergence over those 64
trajectories (tests/fixtures/torch_episode_floor.json, by the same
writer): N_DRAWS runs of each leg from resets moved 1 ulp, and per
statistic the gate is the 0.9 quantile of the draws (the share within
0.05: the 0.1 quantile).  The statistics are scripts/chaos_floor.py:83-95's
(the median, the 90th percentile and the share within 0.05 of `dpos`, over
the 64 envs' bodies) and the mean |score difference| over the envs.  It
applies with no allowance.

Tier 1 checks the fixture (its legs, its actions, its resets, its distinct
trajectories, MoveToCorner's scoring envs, the gate against its draws) and
holds one plain step from each leg's resets against its step-1 state.  The
`slow` test runs the port's plain physics over each whole episode and holds
its end poses and scores to the gate; chip_smoke.py's `[episode]` phase
holds the control-step kernel (K1) to the same gate on the card."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from magical_tpu.tasks import ALL_TASKS as JAX_TASKS
from magical_tpu_torch.core import physics as TP
from magical_tpu_torch.core.convert import state_from_numpy
from magical_tpu_torch.core.state import EnvState
from magical_tpu_torch.tasks import ALL_TASKS

from _torch_episode_fixture import (B, FLOOR, HOLD, LEGS, N_DRAWS, N_NUDGED,
                                    OUT, STATS, TASKS, action_script,
                                    draw_stats, gate, leg_actions)
from _torch_port import max_abs, torch_to_numpy
from test_torch_physics import FIELDS, ONE_STEP_ATOL

# MoveToCorner's envs whose reference end score is above 0, at least
MIN_SCORING = 16


def _load():
    with np.load(OUT) as data:
        return {k: data[k] for k in data.files}


def _floor():
    with open(FLOOR) as f:
        return json.load(f)


def fixture_fields(data, task, which, rows=slice(None)):
    """{field: numpy} of the fixture's `which` state of `task`."""
    return {f.name: data[f'{task}/{which}/{f.name}'][rows]
            for f in dataclasses.fields(EnvState)}


@pytest.mark.parametrize('task', TASKS)
def test_the_fixture_holds_64_distinct_trajectories(task):
    data = _load()
    n_steps = ALL_TASKS[task].ep_len
    assert LEGS[task] == (ALL_TASKS[task].max_blocks, n_steps) \
        == (JAX_TASKS[task].max_blocks, JAX_TASKS[task].ep_len)
    assert data[f'{task}/actions'].shape == (n_steps, B) == (n_steps, 64)
    assert data[f'{task}/reset/pos'].shape[0] == B
    assert data[f'{task}/score'].shape == (B,)
    np.testing.assert_array_equal(data[f'{task}/end/t'], np.full(B, n_steps))
    assert data[f'{task}/trace_steps'][-1] == n_steps
    np.testing.assert_array_equal(data[f'{task}/trace_pos'][-1],
                                  data[f'{task}/end/pos'])
    # no two envs end in the same state
    end = np.concatenate([data[f'{task}/end/pos'].reshape(B, -1),
                          data[f'{task}/end/angle'].reshape(B, -1)], 1)
    assert len(np.unique(end, axis=0)) == B
    if task == 'MoveToCorner':
        assert int((data[f'{task}/score'] > 0).sum()) >= MIN_SCORING


@pytest.mark.parametrize('task', TASKS)
def test_the_actions_come_back_from_the_seed(task):
    """Env 0 takes scripts/chaos_floor.py's script; envs 1-63 the held
    actions the writer draws from its stated seed (on MatchRegions and
    ClusterColour each action held for at least HOLD[0] steps, but the
    last, which the episode cuts); no two envs take the same actions."""
    acts = _load()[f'{task}/actions']
    np.testing.assert_array_equal(acts, leg_actions(task))
    assert acts[:, 0].tolist() == action_script(len(acts))
    assert len({tuple(c) for c in acts.T}) == B
    if task != 'MoveToCorner':
        for col in acts[:, 1:].T:
            cut = np.flatnonzero(np.diff(col)) + 1
            runs = np.diff(np.concatenate([[0], cut]))
            assert runs.min(initial=HOLD[0]) >= HOLD[0]
    assert set(np.unique(acts)) <= set(range(18))


def test_the_legs_start_from_the_chaos_floor_legs_reset():
    """Every leg's 64 resets are JAX's Demo reset from PRNGKey(0), the
    reset of scripts/chaos_floor.py's legs; Demo resets are all alike, so
    env 0 of MatchRegions and ClusterColour starts where that script's
    leg did."""
    data = _load()
    key = jax.random.split(jax.random.PRNGKey(0), B)[0]
    for task in TASKS:
        t = JAX_TASKS[task]
        want = jax.jit(lambda k: t.reset_fn(k, t.flags_for('Demo')))(key)
        for f in dataclasses.fields(EnvState):
            got = data[f'{task}/reset/{f.name}']
            np.testing.assert_array_equal(
                got, np.repeat(np.asarray(getattr(want, f.name))[None], B, 0),
                err_msg=f'{task} {f.name}')


@pytest.mark.parametrize('task', TASKS)
def test_one_step_from_the_fixture_resets(task):
    """One plain control step of the first N_NUDGED converted resets, each
    under its env's first action, against the fixture's step-1 state,
    within the one-step tolerance of tests/test_torch_physics.py or twice
    the reference's own divergence from its 1-ulp nudged resets,
    whichever is larger (the first step from a reset is chaotic in the
    reference: ROADMAP.md, "Faults found")."""
    data = _load()
    rows = slice(0, N_NUDGED)
    st = state_from_numpy(fixture_fields(data, task, 'reset', rows), 'cpu')
    act = torch.as_tensor(data[f'{task}/actions'][0, rows])
    got = torch_to_numpy(TP.control_step(st, act))
    want = fixture_fields(data, task, 'step1', rows)
    for f in FIELDS:
        chaos = max(max_abs(data[f'{task}/nudge{k}/{f}'], want[f])
                    for k in range(4))
        tol = max(ONE_STEP_ATOL[f], 2.0 * chaos)
        assert max_abs(got[f], want[f]) <= tol, (f, tol)
    np.testing.assert_array_equal(got['t'], want['t'])


@pytest.mark.parametrize('task', TASKS)
def test_the_gate_is_the_stated_quantile_of_the_draws(task):
    """torch_episode_floor.json's `gate` is its rule applied to its
    N_DRAWS (>= 16) draws of the reference's 1-ulp experiment over the
    leg's 64 trajectories, and a draw's statistics are what draw_stats
    gives."""
    floor = _floor()[task]
    assert (floor['B'], floor['n_steps'], floor['max_blocks']) == (
        B, LEGS[task][1], LEGS[task][0])
    assert floor['n_draws'] == N_DRAWS >= 16
    draws = floor['draws']
    assert all(len(draws[s]) == N_DRAWS for s in STATS)
    assert {s: floor['gate'][s] for s in STATS} == gate(draws)
    for s in STATS:
        q = 10 if s.startswith('frac') else 90
        assert floor['gate'][s] == float(np.percentile(draws[s], q))
    assert floor['scores_above_0'] == int((_load()[f'{task}/score'] > 0).sum())
    # the statistics of a run against itself: no divergence
    data = _load()
    same = draw_stats(data[f'{task}/end/pos'], data[f'{task}/score'],
                      data[f'{task}/end/pos'], data[f'{task}/score'])
    assert same == dict(dpos_median=0.0, dpos_p90=0.0, frac_within_0p05=1.0,
                        dscore_mean=0.0)


@pytest.mark.slow
@pytest.mark.parametrize('task', TASKS)
def test_whole_episode_within_the_chaos_floor(task):
    data = _load()
    bound = _floor()[task]['gate']
    st = state_from_numpy(fixture_fields(data, task, 'reset'), 'cpu')
    # a plain step of 64 envs takes seconds on one thread
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        for a in data[f'{task}/actions']:
            st = TP.control_step(st, torch.as_tensor(a))
    finally:
        torch.set_num_threads(threads)
    stats = draw_stats(st.pos.numpy(), ALL_TASKS[task].score_fn(st).numpy(),
                       data[f'{task}/end/pos'], data[f'{task}/score'])
    print(task, stats, bound)
    assert stats['dpos_median'] <= bound['dpos_median']
    assert stats['dpos_p90'] <= bound['dpos_p90']
    assert stats['frac_within_0p05'] >= bound['frac_within_0p05']
    assert stats['dscore_mean'] <= bound['dscore_mean']
