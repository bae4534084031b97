"""The check against a broken timed path and against the control, on the
CPU at a size a test run holds: one whole MoveToCorner episode of 4 envs,
every row compared.  Each fault is planted underneath the harness, in the
port's own entry points, and the rest of the run is the benchmark's; each
has to come out not correct, and the sound program correct.  (The cells
run on one card, with no exchange between cards to leave out.)"""

import pytest
import torch

from magical_tpu_torch.core import physics_kernel, preproc
from portbench.harness import bench, check, spec

CELL = 'mtc-demo-lo'
SEED = 2 ** 31 + 977


def run(**kw):
    return bench.run_cell(spec.cell(CELL), SEED, 1e9, False, device='cpu',
                          batch=4, episodes=1, **kw)


def test_the_sound_program_is_correct():
    r = run()
    assert r['correct'], r['checks']


def test_the_control_fails_the_check():
    r = run(control=True)
    limits = spec.cell(CELL).traffic['limits']
    assert not check.verdict(r['control'], limits), r['control']


def unchanged(state, action, **kw):
    return state


def half_left_out(state, action, **kw):
    new = step(state, action)
    keep = torch.arange(state.batch) >= state.batch // 2
    return new.replace(**{f: torch.where(
        keep.reshape((-1,) + (1,) * (getattr(new, f).dim() - 1)),
        getattr(state, f), getattr(new, f))
        for f in ('pos', 'angle', 'vel', 'omega')})


def velocities_not_written(state, action, **kw):
    return step(state, action).replace(vel=state.vel, omega=state.omega)


def caches_dropped(state, action, **kw):
    """The warm-start caches the step writes dropped (the next step
    starts cold)."""
    new = step(state, action)
    return new.replace(con_id=torch.full_like(new.con_id, -1),
                       **{f: torch.zeros_like(getattr(new, f))
                          for f in ('con_jn', 'con_jt', 'joint_acc')})


def obs_altered(spec_, bufs, t, res):
    obs = observe(spec_, bufs, t, res).clone()
    obs[:, 40, 40, -1] ^= 1
    return obs


step = physics_kernel.control_step
observe = preproc.observation_cf
FAULTS = {
    'a step that returns its state unchanged':
        (physics_kernel, 'control_step', unchanged),
    'half of the batch left out of the step':
        (physics_kernel, 'control_step', half_left_out),
    'the velocities left unwritten by the step':
        (physics_kernel, 'control_step', velocities_not_written),
    'the warm-start caches dropped between steps':
        (physics_kernel, 'control_step', caches_dropped),
    'an observation altered where it is produced':
        (preproc, 'observation_cf', obs_altered),
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_a_broken_timed_path_fails_the_check(fault, monkeypatch):
    module, name, broken = FAULTS[fault]
    monkeypatch.setattr(module, name, broken)
    r = run()
    assert not r['correct'], r['checks']


def test_an_altered_score_fails_the_check():
    from magical_tpu_torch.tasks import ALL_TASKS
    task = ALL_TASKS['MoveToCorner']
    score = task.score_fn
    object.__setattr__(task, 'score_fn', lambda state: score(state) + 1e-2)
    try:
        r = run()
    finally:
        object.__setattr__(task, 'score_fn', score)
    assert not r['correct'], r['checks']
