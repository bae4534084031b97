"""The whole-episode hold of magical_tpu_torch's physics against the
reference: tests/fixtures/torch_episode_reference.npz holds magical_tpu's
XLA episodes of three legs (MoveToCorner, mb 1, 80 steps; MatchRegions, mb
8, 120; ClusterColour, mb 10, 240), each 64 Demo resets from PRNGKey(0)
driven by 64 distinct action sequences (env 0 scripts/chaos_floor.py's
script, envs 1-63 held actions drawn from a stated seed), written by
tests/_torch_episode_fixture.py.

The bound is the reference's own divergence under 1-ulp nudges
(tests/fixtures/torch_episode_floor.json, by the same writer), in two
parts: the end part, N_DRAWS runs of each leg from resets moved 1 ulp,
read at the episode's end (scripts/chaos_floor.py:83-95's `dpos` median,
90th percentile and share within 0.05; the mean |score difference|
recorded beside them); and the step part, N_STEP draws of one control step
into each step horizon from the reference's own state moved 1 ulp in pos,
angle, vel and omega (per horizon and field the median over the envs of
the largest difference).  A candidate is held to each part by one
permutation test (_torch_episode_fixture.hold): its largest log ratio to
the median of all runs must not be above every draw's, so a right path
that is exchangeable with the draws fails it at most 1/(draws + 1) of
the time.

Tier 1 checks the fixture (its legs, its actions, its resets, its distinct
trajectories, MoveToCorner's scoring envs), both parts against their
draws, the rule's level and power on synthetic runs, chip_smoke.py's
copies of the rule and of the step statistics, step draw 1 against its
seed, one plain step a leg, and MoveToCorner's step part passing the plain
path and failing M2.  The `slow` tests run the port's plain physics, and
mutants of it (tests/_torch_episode_mutants.py), over each whole episode
and through the step part and hold them to both parts; chip_smoke.py's
`[episode]` phase holds the control-step kernel (K1) to the same parts on
the card."""

import dataclasses
import multiprocessing as mp
import os
import sys

import jax
import numpy as np
import pytest
import torch

from magical_tpu.tasks import ALL_TASKS as JAX_TASKS
from magical_tpu_torch.core import physics as TP
from magical_tpu_torch.core.convert import state_from_numpy
from magical_tpu_torch.core.state import EnvState
from magical_tpu_torch.tasks import ALL_TASKS

from _torch_episode_fixture import (
    B, END_HELD, HOLD, HORIZONS, LEGS, N_DRAWS, N_NUDGED, N_STEP, STATS,
    STEP_FIELDS, TASKS, action_script, draw_stats, draws_T, hold,
    leg_actions, part_draws, run_step, step_horizons, step_maxima, step_pair,
    step_signs, step_stats)
from _torch_episode_mutants import (CANDIDATES, candidate_steps,
                                    fixture_fields, load_fixture, load_floor,
                                    run_candidate, step_leg, verdicts)
from _torch_port import max_abs, torch_to_numpy
from test_torch_physics import FIELDS, ONE_STEP_ATOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# MoveToCorner's envs whose reference end score is above 0, at least
MIN_SCORING = 16


@pytest.mark.parametrize('task', TASKS)
def test_the_fixture_holds_64_distinct_trajectories(task):
    data = load_fixture()
    n_steps = ALL_TASKS[task].ep_len
    assert LEGS[task] == (ALL_TASKS[task].max_blocks, n_steps) \
        == (JAX_TASKS[task].max_blocks, JAX_TASKS[task].ep_len)
    assert data[f'{task}/actions'].shape == (n_steps, B) == (n_steps, 64)
    assert data[f'{task}/reset/pos'].shape[0] == B
    assert data[f'{task}/score'].shape == (B,)
    np.testing.assert_array_equal(data[f'{task}/end/t'], np.full(B, n_steps))
    steps = list(data[f'{task}/trace_steps'])
    assert steps[0] == 1 and steps[-1] == n_steps
    np.testing.assert_array_equal(data[f'{task}/trace_pos'][-1],
                                  data[f'{task}/end/pos'])
    np.testing.assert_array_equal(data[f'{task}/trace_pos'][0],
                                  data[f'{task}/step1/pos'])
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
    acts = load_fixture()[f'{task}/actions']
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
    data = load_fixture()
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
    data = load_fixture()
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
def test_the_parts_come_back_from_their_draws(task):
    """torch_episode_floor.json's parts follow from their draws: the end
    part's N_DRAWS (>= 16) draws of the 1-ulp experiment, four statistics
    each, three held and the mean |score difference| recorded; the step
    part's N_STEP (>= 64) draws, one statistic per step horizon and field;
    the npz holds the reference's state before each step horizon and its
    poses and velocities after it; each part's level is 1/(draws + 1) and
    its draws' T (among the draws alone) what the rule gives."""
    data, floor = load_fixture(), load_floor()
    end, step = floor['end'], floor['step']
    leg = end['legs'][task]
    assert (leg['B'], leg['n_steps'], leg['max_blocks']) == (
        B, LEGS[task][1], LEGS[task][0])
    assert end['n_draws'] == N_DRAWS >= 16 and end['stats'] == list(STATS)
    assert end['recorded'] == ['dscore_mean'] and END_HELD == STATS[:3]
    assert all(len(leg['draws'][s]) == N_DRAWS for s in STATS)
    assert leg['scores_above_0'] == int((data[f'{task}/score'] > 0).sum())
    horizons = step_horizons(task)
    assert horizons == (1, 2, 4, 8, 16, 32, LEGS[task][1])
    assert step['n_draws'] == N_STEP >= 64
    assert step['fields'] == list(STEP_FIELDS)
    assert step['legs'][task]['horizons'] == list(horizons)
    draws = step['legs'][task]['draws']
    assert sorted(draws) == sorted(f'{f}_h{h}' for h in horizons
                                   for f in STEP_FIELDS)
    assert all(len(v) == N_STEP for v in draws.values())
    for h in horizons:
        before, act, after = step_pair(data, task, h)
        assert set(before) == {f.name for f in dataclasses.fields(EnvState)}
        np.testing.assert_array_equal(before['t'], np.full(B, h - 1))
        assert act.shape == (B,) and set(after) == set(STEP_FIELDS)
        assert after['pos'].shape == before['pos'].shape
    for part in (end, step):
        assert part['level'] == 1 / (part['n_draws'] + 1)
    assert end['T_draws'] == draws_T(part_draws(floor, 'end'))
    assert step['T_draws'] == draws_T(part_draws(floor, 'step'))
    assert set(part_draws(floor, 'end')) == {
        f'{t}/{s}' for t in TASKS for s in END_HELD}
    # a run against itself: no divergence in either part
    same = draw_stats(data[f'{task}/end/pos'], data[f'{task}/score'],
                      data[f'{task}/end/pos'], data[f'{task}/score'])
    assert same == dict(dpos_median=0.0, dpos_p90=0.0, frac_within_0p05=1.0,
                        dscore_mean=0.0)
    _, _, after = step_pair(data, task, horizons[-1])
    assert set(step_stats({horizons[-1]: step_maxima(
        after, after)}).values()) == {0.0}


def _synthetic_runs(rng, names, n_runs):
    """Positive statistics of `n_runs` exchangeable runs, log-normal and
    correlated through a shared factor; the shares (lower worse) below
    1."""
    z = (np.sqrt(0.5) * rng.randn(1, n_runs)
         + np.sqrt(0.5) * rng.randn(len(names), n_runs))
    x = np.exp(0.3 * z)
    share = np.array([s.split('/')[1].startswith('frac') for s in names])
    return np.where(share[:, None], 1 - 0.3 * x, x), z


def test_the_rule_has_its_level_and_its_power():
    """On SETS synthetic sets of 17 exchangeable runs (a candidate and 16
    draws) of 12 positive statistics correlated through a shared factor
    (three of them shares, lower worse), drawn from a seed: the candidate
    fails at the rate exchangeability gives, within a binomial 99.9%
    interval of 1/17; a candidate moved 3 spreads the worse way in every
    statistic fails in at least 90% of the sets (the largest log ratio
    gives up a little of the rank sum's power on a shift spread over all
    statistics), and one moved 10 spreads in one statistic alone, which a
    rank sum over 12 statistics cannot see, in nearly every set."""
    from scipy.stats import binom
    sets, n_runs, level = 4000, 17, 1 / 17
    names = [f'leg{j}/{s}' for j in range(3) for s in STATS]
    rng = np.random.RandomState(0)
    fails = shifted_fails = one_fails = 0
    for _ in range(sets):
        x, z = _synthetic_runs(rng, names, n_runs)
        cand = {s: x[i, 0] for i, s in enumerate(names)}
        draws = {s: x[i, 1:] for i, s in enumerate(names)}
        r = hold(cand, draws)
        assert r['level'] == level
        fails += not r['passed']
        # T is each run's largest log ratio to the median of the runs
        worse = np.log(np.where([s.split('/')[1].startswith('frac')
                                 for s in names], 1 - x.T, x.T).T)
        t = (worse - np.median(worse, 1, keepdims=True)).max(0)
        np.testing.assert_allclose([r['T'], r['T_draws_max']],
                                   [t[0], t[1:].max()], rtol=1e-12)
        spread = 0.3 * z[:, 1:].std()
        moved = {s: (1 - (1 - v) * np.exp(3 * spread))
                 if s.split('/')[1].startswith('frac')
                 else v * np.exp(3 * spread) for s, v in cand.items()}
        shifted_fails += not hold(moved, draws)['passed']
        one = dict(cand, **{names[0]: cand[names[0]] * np.exp(10 * spread)})
        one_fails += not hold(one, draws)['passed']
    lo, hi = binom.ppf([0.0005, 0.9995], sets, level)
    assert lo <= fails <= hi, fails
    assert shifted_fails >= 0.9 * sets, shifted_fails
    assert one_fails >= 0.99 * sets, one_fails
    print(f'moved 3 spreads in all: {shifted_fails} of {sets} fail; '
          f'10 in one: {one_fails}')


def test_chip_smoke_holds_by_the_same_rule():
    """chip_smoke.py keeps its own copy of the rule and of the step part's
    statistics (it imports nothing from tests/): on the stored draws of
    both parts, with draw 0 taken as the candidate (made worse in one
    statistic, and NaN in another), the copy of the rule gives what
    _torch_episode_fixture.hold gives; its step statistics of
    MoveToCorner, through K1's wrapper on the CPU (the plain version),
    are the plain path's by _torch_episode_mutants.step_leg."""
    sys.path.insert(0, REPO)
    import chip_smoke
    floor = load_floor()
    for part in ('end', 'step'):
        draws = part_draws(floor, part)
        cand = {s: v[0] for s, v in draws.items()}
        rest = {s: v[1:] for s, v in draws.items()}
        for edit in ({}, {next(iter(cand)): np.inf},
                     {sorted(cand)[-1]: np.nan}):
            c = dict(cand, **edit)
            assert chip_smoke.hold(c, rest) == hold(c, rest), (part, edit)
    assert chip_smoke.STEP_FIELDS == STEP_FIELDS
    data, task = load_fixture(), 'MoveToCorner'
    device = chip_smoke.DEVICE
    chip_smoke.DEVICE = 'cpu'
    try:
        got = chip_smoke.step_stats(data, task, step_horizons(task))
    finally:
        chip_smoke.DEVICE = device
    assert got == step_leg(TP.control_step, data, task)


def test_the_step_draws_come_back_from_their_seeds():
    """N_STEP draws at the step horizons; draw 1's signs are
    RandomState(1)'s, horizon after horizon and field after field, and
    draw 1 of MoveToCorner, run again on XLA from the npz's states, gives
    the statistics the json keeps for it."""
    assert (N_STEP, HORIZONS) == (64, (1, 2, 4, 8, 16, 32))
    assert STEP_FIELDS == ('pos', 'angle', 'vel', 'omega')
    data, floor = load_fixture(), load_floor()
    task = 'MoveToCorner'
    shapes = {f: data[f'{task}/reset/{f}'].shape for f in STEP_FIELDS}
    horizons = step_horizons(task)
    signs = list(step_signs(1, shapes, len(horizons)))
    rng = np.random.RandomState(1)
    assert len(signs) == len(horizons)
    for up in signs:
        for f in STEP_FIELDS:
            np.testing.assert_array_equal(
                up[f], rng.randint(0, 2, shapes[f]).astype(bool))
    got = run_step(task, 1, data)
    want = floor['step']['legs'][task]['draws']
    assert step_stats({h: {f: got[f][i] for f in STEP_FIELDS}
                       for i, h in enumerate(horizons)}) == {
        s: v[1] for s, v in want.items()}


def test_the_step_part_of_move_to_corner_holds_the_plain_path_not_m2():
    """The step part (64 draws, level 1/65) with MoveToCorner's statistics
    from a candidate and the other legs' at the draws' median (which
    moves no median and adds nothing to T): the plain path passes it,
    and M2 (9 solver iterations), whose step into step 32 leaves the
    reference in the middle of a push, fails it, as it fails the whole
    part on MoveToCorner alone."""
    data, floor = load_fixture(), load_floor()
    task = 'MoveToCorner'
    draws = part_draws(floor, 'step')
    neutral = {s: float(np.median(v)) for s, v in draws.items()}
    for name, passes in (('plain', True), ('M2', False)):
        with CANDIDATES[name]() as step:
            stats = step_leg(step, data, task)
        v = hold(dict(neutral, **{f'{task}/{s}': x
                                  for s, x in stats.items()}), draws)
        assert v['passed'] == passes, (name, v['T'], v['T_draws_max'])


def _whole_episodes(name):
    """Candidate `name` over every leg: its whole episodes, a process a
    leg, and its step part; the verdicts of both parts."""
    with mp.get_context('spawn').Pool(len(TASKS)) as pool:
        runs = dict(pool.map(run_candidate, [(name, t, 2) for t in TASKS],
                             chunksize=1))
    data = load_fixture()
    return verdicts(runs, candidate_steps(name, data), data, load_floor())


@pytest.mark.slow
def test_whole_episode_within_the_chaos_floor():
    """The plain path passes both parts: its whole episodes the end part,
    its steps the step part."""
    v = _whole_episodes('plain')
    print(v)
    assert v['end']['passed'] and v['step']['passed']


@pytest.mark.slow
@pytest.mark.parametrize('name', ['M1', 'M2'])
def test_a_wrong_physics_fails_the_hold(name):
    """M1 (the warm-start caches dropped between control steps) and M2
    (9 solver iterations) each fail a part."""
    v = _whole_episodes(name)
    print(v)
    assert not (v['end']['passed'] and v['step']['passed'])
