"""The whole-episode hold of magical_tpu_torch's physics against the
reference: tests/fixtures/torch_episode_reference.npz holds magical_tpu's
XLA episode of scripts/chaos_floor.py's legs (64 Demo resets from
PRNGKey(0), the 40-action script, `ep_len` control steps of MatchRegions
and ClusterColour), written by tests/_torch_episode_fixture.py.

Tier 1 holds one plain step from the fixture's resets against its step-1
state.  The `slow` test runs the port's plain physics over the whole
episode from the converted resets: its end poses may diverge from the
reference's by no more than a 1-ulp self-divergence (the median, the 90th
percentile and the share within 0.05 of `dpos`, computed as
scripts/chaos_floor.py:83-95 does), and its end scores must equal the
reference's env by env (every end score of this script is 0, so that
equality says little until a scoring episode is added).
chip_smoke.py's `[episode]` phase runs the control-step kernel (K1) over
the same episodes.

The bound is the reference's own (tests/fixtures/chaos_floor.json: every
position 1 ulp up, the episode run again, the same statistics), with no
allowance.  The kernel's gate in `[episode]` is the `gate` entry of
tests/fixtures/torch_chaos_floor.json, written by
tests/_torch_chaos_floor.py from 64 draws of the same 1-ulp experiment
on the port's plain path; the tier-1 tests here check that entry against
its draws."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from magical_tpu.tasks import ALL_TASKS as JAX_TASKS
from magical_tpu_torch.core import physics as TP
from magical_tpu_torch.core.convert import state_from_numpy
from magical_tpu_torch.core.state import EnvState
from magical_tpu_torch.tasks import ALL_TASKS

from _torch_chaos_floor import N_DRAWS, STATS, dpos_stats, gate
from _torch_episode_fixture import B, N_NUDGED, OUT, TASKS, action_script
from _torch_port import max_abs, torch_to_numpy
from test_torch_physics import FIELDS, ONE_STEP_ATOL

FLOOR = os.path.join(os.path.dirname(OUT), 'chaos_floor.json')
PORT_FLOOR = os.path.join(os.path.dirname(OUT), 'torch_chaos_floor.json')


def _load():
    with np.load(OUT) as data:
        return {k: data[k] for k in data.files}


def fixture_fields(data, task, which, rows=slice(None)):
    """{field: numpy} of the fixture's `which` state of `task`."""
    return {f.name: data[f'{task}/{which}/{f.name}'][rows]
            for f in dataclasses.fields(EnvState)}


def test_the_fixture_holds_the_chaos_floor_legs():
    data = _load()
    with open(FLOOR) as f:
        floor = json.load(f)
    with open(PORT_FLOOR) as f:
        port = json.load(f)
    assert data['actions'].tolist() == action_script(len(data['actions']))
    for task in TASKS:
        for fl in (floor, port):
            # the port's top-level entry is its draw 0, the reference's
            # experiment: every position 1 ulp up
            assert fl[task]['B'] == B and fl[task]['perturb'] == '1 ulp on pos'
            assert fl[task]['n_steps'] == JAX_TASKS[task].ep_len \
                == ALL_TASKS[task].ep_len
        assert data[f'{task}/reset/pos'].shape[0] == B
        assert data[f'{task}/score'].shape == (B,)
        np.testing.assert_array_equal(data[f'{task}/end/t'],
                                      np.full(B, ALL_TASKS[task].ep_len))
        assert data[f'{task}/trace_steps'][-1] == ALL_TASKS[task].ep_len
        np.testing.assert_array_equal(data[f'{task}/trace_pos'][-1],
                                      data[f'{task}/end/pos'])
    assert os.path.getsize(OUT) < 1 << 20


@pytest.mark.parametrize('task', TASKS)
def test_one_step_from_the_fixture_resets(task):
    """One plain control step of the first N_NUDGED converted resets
    against the fixture's step-1 state, within the one-step tolerance of
    tests/test_torch_physics.py or twice the reference's own divergence
    from its 1-ulp nudged resets, whichever is larger (the first step from
    a reset is chaotic in the reference: ROADMAP.md, "Faults found")."""
    data = _load()
    rows = slice(0, N_NUDGED)
    st = state_from_numpy(fixture_fields(data, task, 'reset', rows), 'cpu')
    act = torch.full((N_NUDGED,), int(data['actions'][0]), dtype=torch.int32)
    got = torch_to_numpy(TP.control_step(st, act))
    want = fixture_fields(data, task, 'step1', rows)
    for f in FIELDS:
        chaos = max(max_abs(data[f'{task}/nudge{k}/{f}'], want[f])
                    for k in range(4))
        tol = max(ONE_STEP_ATOL[f], 2.0 * chaos)
        assert max_abs(got[f], want[f]) <= tol, (f, tol)
    np.testing.assert_array_equal(got['t'], want['t'])


@pytest.mark.parametrize('task', TASKS)
def test_the_kernel_gate_is_the_stated_quantile_of_the_draws(task):
    """torch_chaos_floor.json's `gate` is what its rule gives from its
    N_DRAWS draws and the reference's bound, and its draw 0 is the
    reference's experiment."""
    with open(FLOOR) as f:
        ref = json.load(f)[task]
    with open(PORT_FLOOR) as f:
        port = json.load(f)[task]
    draws = port['draws']
    assert draws['n'] == N_DRAWS
    assert all(len(draws[s]) == N_DRAWS for s in STATS)
    assert all(draws[s][0] == port[s] for s in STATS)
    want = gate(ref, draws)
    assert {s: port['gate'][s] for s in STATS} == want
    assert want['dpos_median'] >= ref['dpos_median']
    assert want['dpos_p90'] >= ref['dpos_p90']
    assert want['frac_within_0p05'] <= ref['frac_within_0p05']


@pytest.mark.slow
@pytest.mark.parametrize('task', TASKS)
def test_whole_episode_within_the_chaos_floor(task):
    data = _load()
    with open(FLOOR) as f:
        bound = json.load(f)[task]
    st = state_from_numpy(fixture_fields(data, task, 'reset'), 'cpu')
    # a plain step of 64 envs takes seconds on one thread
    threads = torch.get_num_threads()
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    try:
        for a in data['actions'][:ALL_TASKS[task].ep_len]:
            st = TP.control_step(st, torch.full((B,), int(a),
                                                dtype=torch.int32))
    finally:
        torch.set_num_threads(threads)
    stats = dpos_stats(st.pos.numpy(), data[f'{task}/end/pos'])
    print(task, stats, bound)
    assert stats['dpos_median'] <= bound['dpos_median']
    assert stats['dpos_p90'] <= bound['dpos_p90']
    assert stats['frac_within_0p05'] >= bound['frac_within_0p05']
    np.testing.assert_array_equal(ALL_TASKS[task].score_fn(st).numpy(),
                                  data[f'{task}/score'])
