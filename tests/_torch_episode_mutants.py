"""Candidates for the whole-episode hold of magical_tpu_torch's physics:
the port's plain path and mutants of it, each run over the legs of
tests/fixtures/torch_episode_reference.npz (whole episodes for the end
part, one step into each step horizon for the step part) and held to both
parts of tests/fixtures/torch_episode_floor.json by
`_torch_episode_fixture.hold`.

The mutants act from outside the package, by editing the state between
control steps or by patching a constant for the length of a run:

  M1  the Pallas kernel's own fault (magical_tpu/core/physics_pallas.py
      zeroes the warm-start caches at each control step): con_id set to
      -1 and con_jn, con_jt and joint_acc to 0 before every control step;
  M2  PHYS_ITER - 1 = 9 solver iterations a substep instead of 10;
  M3  SHAPE_FRICTION 5% high;
  M4  the friction warm start alone dropped: con_jt set to 0 before every
      control step;
  M5  COLLISION_SLOP 10% high.

M4 and M5 were written after the hold's statistic was fixed, and run
only then: they measure its power on faults it was not shaped on.  A
right physics fails a part at most at its level; a hold that calls
faults must fail M1 and M2.  `quantile_gate` is the gate the hold replaced (per
statistic the 0.9 quantile of the end draws, the share within 0.05 the
0.1 quantile, all twelve held), kept to record its verdicts.

Each candidate's run of a leg is kept under build/episode_candidates/
(`kept_path`), so a second call only holds them.  Run (no JAX; a process
per candidate and leg, ClusterColour's the longest):

    python tests/_torch_episode_mutants.py [--workers N] [--threads T] \\
        [CANDIDATE ...]
"""

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import inspect
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_episode_fixture import (  # noqa: E402
    FLOOR, OUT, REPO, STATS, STEP_FIELDS, TASKS, draw_stats, hold,
    part_draws, step_horizons, step_maxima, step_pair, step_stats)


def load_fixture():
    with np.load(OUT) as f:
        return {k: f[k] for k in f.files}


def load_floor():
    with open(FLOOR) as f:
        return json.load(f)


def fixture_fields(data, task, which, rows=slice(None)):
    """{field: numpy} of the fixture's `which` state of `task`."""
    from magical_tpu_torch.core.state import EnvState
    return {f.name: data[f'{task}/{which}/{f.name}'][rows]
            for f in dataclasses.fields(EnvState)}


@contextlib.contextmanager
def plain():
    from magical_tpu_torch.core import physics
    yield physics.control_step


@contextlib.contextmanager
def m1_cold_caches():
    import torch
    from magical_tpu_torch.core import physics

    def step(st, act):
        st = st.replace(con_id=torch.full_like(st.con_id, -1),
                        con_jn=torch.zeros_like(st.con_jn),
                        con_jt=torch.zeros_like(st.con_jt),
                        joint_acc=torch.zeros_like(st.joint_acc))
        return physics.control_step(st, act)
    yield step


@contextlib.contextmanager
def m2_nine_iterations():
    from magical_tpu_torch import constants as C
    from magical_tpu_torch.core import physics
    substep = physics.physics_substep
    physics.physics_substep = functools.partial(
        substep, iterations=C.PHYS_ITER - 1)
    try:
        yield physics.control_step
    finally:
        physics.physics_substep = substep


@contextlib.contextmanager
def m3_shape_friction_high():
    from magical_tpu_torch import constants as C
    from magical_tpu_torch.core import physics
    friction = C.SHAPE_FRICTION

    def set_friction(x):
        C.SHAPE_FRICTION = x
        physics.slot_tables.cache_clear()
        physics.candidate_bodies.cache_clear()
    set_friction(friction * 1.05)
    try:
        yield physics.control_step
    finally:
        set_friction(friction)


@contextlib.contextmanager
def m4_cold_friction():
    import torch
    from magical_tpu_torch.core import physics

    def step(st, act):
        return physics.control_step(
            st.replace(con_jt=torch.zeros_like(st.con_jt)), act)
    yield step


@contextlib.contextmanager
def m5_slop_high():
    from magical_tpu_torch import constants as C
    from magical_tpu_torch.core import physics
    slop = C.COLLISION_SLOP
    C.COLLISION_SLOP = slop * 1.1
    try:
        yield physics.control_step
    finally:
        C.COLLISION_SLOP = slop


CANDIDATES = {'plain': plain, 'M1': m1_cold_caches,
              'M2': m2_nine_iterations, 'M3': m3_shape_friction_high,
              'M4': m4_cold_friction, 'M5': m5_slop_high}


def run_leg(step, data, task):
    """`step` over `task`'s whole episode from the fixture's resets under
    its actions, on the CPU: {'end_pos', 'score'}."""
    import torch
    from magical_tpu_torch.core.convert import state_from_numpy
    from magical_tpu_torch.tasks import ALL_TASKS
    st = state_from_numpy(fixture_fields(data, task, 'reset'), 'cpu')
    for a in data[f'{task}/actions']:
        st = step(st, torch.as_tensor(a))
    return dict(end_pos=st.pos.numpy(),
                score=ALL_TASKS[task].score_fn(st).numpy())


def step_leg(step, data, task):
    """`step`'s step part of `task`: one control step into each step
    horizon from the fixture's unmoved state, its step_stats."""
    import torch
    from magical_tpu_torch.core.convert import state_from_numpy
    maxima = {}
    for h in step_horizons(task):
        before, act, after = step_pair(data, task, h)
        nxt = step(state_from_numpy(before, 'cpu'), torch.as_tensor(act))
        maxima[h] = step_maxima({f: getattr(nxt, f).numpy()
                                 for f in STEP_FIELDS}, after)
    return step_stats(maxima)


def end_stats(run, data, task):
    """A run_leg run's end statistics."""
    return draw_stats(run['end_pos'], run['score'],
                      data[f'{task}/end/pos'], data[f'{task}/score'])


def quantile_gate(stats, floor, task):
    """The replaced gate on one leg: whether each end statistic is within
    the 0.9 quantile of the end draws (the share within 0.05: above the
    0.1 quantile)."""
    draws = floor['end']['legs'][task]['draws']
    return {s: (stats[s] >= np.percentile(draws[s], 10)
                if s.startswith('frac')
                else stats[s] <= np.percentile(draws[s], 90)) for s in STATS}


def verdicts(runs, steps, data, floor):
    """The replaced gate's and both parts' verdicts of one candidate from
    its run_leg runs {task: run} and its step_leg statistics {task:
    stats} over every leg."""
    end = {t: end_stats(r, data, t) for t, r in runs.items()}
    gate = {t: quantile_gate(e, floor, t) for t, e in end.items()}
    end = {f'{t}/{s}': v for t, e in end.items() for s, v in e.items()}
    step = {f'{t}/{s}': v for t, x in steps.items() for s, v in x.items()}
    return dict(gate=gate, end=hold(end, part_draws(floor, 'end')),
                step=hold(step, part_draws(floor, 'step')),
                stats=dict(end=end, step=step))


def kept_path(name, task):
    """Where a candidate's run of a leg is kept: named by a hash of the
    leg's resets and actions, the port's physics and the candidate's
    source, so that a change to any of them runs it again."""
    data = load_fixture()
    h = hashlib.sha1(inspect.getsource(CANDIDATES[name]).encode())
    for k in sorted(data):
        if k.startswith(f'{task}/reset/') or k == f'{task}/actions':
            h.update(data[k].tobytes())
    with open(os.path.join(REPO, 'magical_tpu_torch', 'core',
                           'physics.py'), 'rb') as f:
        h.update(f.read())
    return os.path.join(REPO, 'build', 'episode_candidates',
                        f'{name}_{task}_{h.hexdigest()[:12]}.npz')


def run_candidate(job):
    """(name, task, threads): candidate `name`'s run_leg of `task` on
    `threads` threads; returns (task, run)."""
    name, task, threads = job
    import torch
    torch.set_num_threads(threads)
    with CANDIDATES[name]() as step:
        return task, run_leg(step, load_fixture(), task)


def candidate_steps(name, data):
    """Candidate `name`'s step_leg statistics of every leg."""
    with CANDIDATES[name]() as step:
        return {t: step_leg(step, data, t) for t in TASKS}


def _job(job):
    name, task, _ = job
    path = kept_path(name, task)
    if not os.path.exists(path):
        t0 = time.perf_counter()
        _, out = run_candidate(job)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path + '.tmp.npz', **out)
        os.replace(path + '.tmp.npz', path)
        print(f'{name} {task} ran in {time.perf_counter() - t0:.1f} s',
              flush=True)
    with np.load(path) as f:
        return name, task, {k: f[k] for k in ('end_pos', 'score')}


def main(argv=None):
    import multiprocessing as mp

    p = argparse.ArgumentParser()
    p.add_argument('candidates', nargs='*', default=list(CANDIDATES))
    p.add_argument('--workers', type=int, default=4)
    p.add_argument('--threads', type=int, default=1)
    args = p.parse_args(argv)
    jobs = [(c, t, args.threads) for t in reversed(TASKS)
            for c in args.candidates]
    with mp.get_context('spawn').Pool(args.workers) as pool:
        done = pool.map(_job, jobs, chunksize=1)
    data, floor = load_fixture(), load_floor()
    for c in args.candidates:
        v = verdicts({t: out for n, t, out in done if n == c},
                     candidate_steps(c, data), data, floor)
        gate = {t: int(sum(g.values())) for t, g in v['gate'].items()}
        print(json.dumps(dict(
            candidate=c,
            quantile_gate={'held': gate, 'passed': all(
                n == len(STATS) for n in gate.values())},
            end=v['end'], step=v['step'], stats=v['stats'])), flush=True)


if __name__ == '__main__':
    main()
