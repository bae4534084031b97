"""Whether what the window produced is right: the readings the reference
gives of it, each held to its limit.

The reference (``portbench/reference``) works each answer out again from
the seed or, where the physics is chaotic, from the program's own state
one step before.  Five numbers, each over the episodes the check plan
takes (the first `episodes` of its order that reached what the number
compares), the largest over them:

  * ``reset_gap``: every field of the state after the reset, the whole
    batch, against the reference's reset from the episode's seed: the
    largest |difference| of a float field, infinite where an integer or
    flag field (the layout's draws: counts, shapes, colours, failed
    placements, seed words) differs;
  * ``step_gap``: one control step of the whole batch from the program's
    state before the check step, with the action the window gave it,
    against the program's state after it: the gap of the float fields
    that are neither a velocity nor a cache (positions, angles, the
    control targets, goals, dynamics) at the TAIL env (each env's largest
    |difference|, then the ceil(TAIL * B)-th largest of those), infinite
    where an integer field, the step counter, `done` (set exactly at the
    last step) or the score (zero before it) is not what the step gives;
    and the largest |difference| of the score after the last step, the
    whole batch, against the reference's score of the program's last
    state.  (A score is a coarse function of the poses: in bfloat16 it
    often comes out the same, so it has no number of its own that the
    control fails on every seed);
  * ``vel_gap``: at the same step and the same TAIL env, the gap of the
    velocities and the solver's pseudo velocities (``vel``, ``omega``,
    ``v_bias``, ``w_bias``);
  * ``cache_gap``: at the same step and the same TAIL env, the gap of the
    warm-start caches the next step starts from: each contact's
    accumulated normal and friction impulse, matched by its candidate id
    (a contact on one side only counts its whole impulse), and the
    joints' accumulated impulses;
  * ``frame_gap``: the observation rows after the reset and at the check
    step against the reference's frames of the program's states, stacked:
    the largest difference of a uint8 level.

The control puts the reference in the program's place, computed in
bfloat16 (``dtype.lowered``), at the same states: its readings are those
of the bfloat16 answers against the float32 ones.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.harness import traffic
from portbench.harness.window import STACK, Window
from portbench.reference import dtype as DT
from portbench.reference.env import Scene, to_float
from portbench.reference.physics import candidate_bodies
from portbench.reference.state import EnvState

NUMBERS = ('reset_gap', 'step_gap', 'vel_gap', 'cache_gap', 'frame_gap')
INF = float('inf')
# the share of the batch whose gaps the step's float numbers leave above
# them: one step is chaotic in the few envs whose contacts sit near a
# threshold, where a change of rounding alone moves them far
TAIL = 0.01
FIELDS = tuple(f.name for f in dataclasses.fields(EnvState))
VELOCITY = ('vel', 'omega', 'v_bias', 'w_bias')
CACHE = ('con_id', 'con_jn', 'con_jt', 'joint_acc')
POSE = tuple(f for f in FIELDS if f not in VELOCITY + CACHE)


def as_reference(state) -> EnvState:
    """The program's state as the reference's type (the same tensors)."""
    return EnvState(**{f: getattr(state, f) for f in FIELDS})


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| in float64; infinite where either is not
    finite."""
    d = (a.double() - b.double()).abs()
    if d.numel() == 0:
        return 0.0
    x = float(d.max())
    return INF if math.isnan(x) else x


def env_gaps(got: EnvState, want: EnvState, fields) -> torch.Tensor:
    """(B,) float64: each env's largest |difference| of the float fields
    among `fields`; infinite where an integer or flag field among them
    differs, or a value is not finite."""
    B = want.batch
    worst = torch.zeros(B, dtype=torch.float64, device=want.device)
    for name in fields:
        a, b = getattr(got, name), getattr(want, name)
        if tuple(a.shape) != tuple(b.shape):
            return torch.full_like(worst, INF)
        if b.is_floating_point():
            d = (a.double() - b.double()).abs().reshape(B, -1).amax(1)
        else:
            d = torch.where((a.to(b.dtype) != b).reshape(B, -1).any(1),
                            INF, 0.0).double()
        worst = torch.maximum(worst, d.nan_to_num(nan=INF))
    return worst


def state_gap(got: EnvState, want: EnvState, fields=FIELDS) -> float:
    """The largest |difference| over the batch of the float fields among
    `fields`; infinite where an integer or flag field among them differs
    anywhere."""
    return float(env_gaps(got, want, fields).max())


def tail(gaps: torch.Tensor) -> float:
    """The gap that all but the worst TAIL of the envs keep under: the
    ceil(TAIL * B)-th largest."""
    k = max(1, math.ceil(TAIL * gaps.numel()))
    return float(torch.topk(gaps, k).values[-1])


def _by_candidate(state: EnvState, x: torch.Tensor, n: int):
    """(B, n) float64: each contact's `x` at its candidate id, 0 where a
    candidate has no contact."""
    ids = state.con_id.long()
    ok = ids >= 0
    out = torch.zeros((ids.shape[0], n + 1), dtype=torch.float64,
                      device=ids.device)
    out.scatter_(1, torch.where(ok, ids, n),
                 torch.where(ok, x.double(), 0.0))
    return out[:, :n]


def cache_gaps(got: EnvState, want: EnvState,
               n_candidates: int) -> torch.Tensor:
    """(B,) float64: each env's largest |difference| of the contact
    impulses matched by candidate id and of the joints' accumulated
    impulses."""
    worst = env_gaps(got, want, ('joint_acc',))
    for f in ('con_jn', 'con_jt'):
        d = (_by_candidate(got, getattr(got, f), n_candidates)
             - _by_candidate(want, getattr(want, f), n_candidates))
        worst = torch.maximum(worst, d.abs().amax(1).nan_to_num(nan=INF))
    return worst


def step_gaps(got: EnvState, want: EnvState, n_candidates: int) -> dict:
    """The step's three numbers of one episode: the integer and flag
    fields exact over the whole batch, each float group at the TAIL
    env."""
    floats = [f for f in POSE if getattr(want, f).is_floating_point()]
    exact = [f for f in POSE if f not in floats]
    return {'step_gap': max(state_gap(got, want, exact),
                            tail(env_gaps(got, want, floats))),
            'vel_gap': tail(env_gaps(got, want, VELOCITY)),
            'cache_gap': tail(cache_gaps(got, want, n_candidates))}


def _cat_states(states):
    return EnvState(**{f: torch.cat([getattr(s, f) for s in states])
                       for f in FIELDS})


def _rows(state, rows):
    return EnvState(**{f: getattr(state, f).index_select(0, rows)
                       for f in FIELDS})


def _chosen(window: Window, order, n, ready):
    """The first `n` episodes of the check plan's `order` that ran and are
    `ready`."""
    ran = {ep.index: ep for ep in window.episodes}
    return [ran[i] for i in order if i in ran and ready(ran[i])][:n]


def readings(scene: Scene, window: Window, plan, episodes: int,
             control: bool = False) -> dict:
    """{number: reading} of the program's answers in `window`, or, with
    `control`, of the control's answers at the same states."""
    order = plan.check_order
    L = plan.ep_len
    dev = plan.env.device
    lowered = DT.lowered if control else None
    out = {}

    # the reset, from the seed
    eps = _chosen(window, order, episodes, lambda ep: True)
    gaps = []
    for ep in eps:
        want = scene.reset(traffic.reset_generator(plan.seed, ep.index),
                           plan.batch, dev)
        if control:
            with lowered():
                got = scene.reset(traffic.reset_generator(plan.seed,
                                                          ep.index),
                                  plan.batch, dev)
        else:
            got = as_reference(ep.reset_state)
        gaps.append(state_gap(got, want))
        del want, got
    out['reset_gap'] = max(gaps, default=INF)

    # one step of the whole batch into the check step, from the program's
    # state before it, one episode at a time
    eps = _chosen(window, order, episodes,
                  lambda ep: ep.steps >= ep.check_step)
    n_candidates = len(candidate_bodies(scene.task.max_blocks)[0])
    gaps = dict.fromkeys(('step_gap', 'vel_gap', 'cache_gap'),
                         INF if not eps else 0.0)
    for ep in eps:
        p = ep.check_step
        pre = as_reference(ep.pre)
        act = plan.actions[(ep.index % plan.pool) * L + p - 1]
        want = scene.step(pre, act)
        if control:
            with lowered():
                got = scene.step(to_float(pre, torch.bfloat16), act)
        else:
            got = as_reference(ep.post)
            score_ok = p >= L or torch.equal(
                ep.score, torch.zeros_like(ep.score))
            if not (score_ok and bool((ep.done == (p >= L)).all())):
                gaps['step_gap'] = INF
        for k, v in step_gaps(got, want, n_candidates).items():
            gaps[k] = max(gaps[k], v)
        del want, got
    step_gap = gaps.pop('step_gap')
    out.update(gaps)

    # the score after the last step, the whole batch
    ends = _chosen(window, order, episodes, lambda ep: ep.steps == L)
    if not ends:
        step_gap = INF
    for ep in ends:
        end = as_reference(ep.end_state)
        want = scene.score(end)
        if control:
            with lowered():
                got = scene.score(to_float(end, torch.bfloat16))
        else:
            got = ep.end_score
            if not bool(ep.end_done.all()):
                step_gap = INF
        step_gap = max(step_gap, _gap(got, want))
    out['step_gap'] = step_gap

    # the frames: the reset's observation, and the stack at the check step
    def before(ep, j):
        """The program's state (the planned rows) after step j."""
        if j <= 0:
            return _rows(as_reference(ep.reset_state), ep.rows)
        return as_reference(ep.states[j])

    frame_gap = INF if not eps else 0.0
    for ep in eps:
        p, n = ep.check_step, len(ep.rows)
        states = _cat_states([before(ep, j)
                              for j in [0] + list(range(p - STACK + 1,
                                                        p + 1))])

        def observations(frames):
            split = [{v: f[k * n:(k + 1) * n] for v, f in frames.items()}
                     for k in range(STACK + 1)]
            return (scene.observation(split[:1]),
                    scene.observation(split[1:]))
        want_reset, want_obs = observations(scene.frames(states))
        if control:
            with lowered():
                got_reset, got_obs = observations(scene.frames(
                    to_float(states, torch.bfloat16)))
        else:
            got_reset, got_obs = ep.reset_obs, ep.obs
        frame_gap = max(frame_gap, _gap(got_reset, want_reset),
                        _gap(got_obs, want_obs))
    out['frame_gap'] = frame_gap

    return out


def _limited(limits: dict, names) -> None:
    missing = [k for k in names if k not in limits]
    if missing:
        raise KeyError(f'no limit for {missing}')


def verdict(values: dict, limits: dict, names=NUMBERS) -> bool:
    """Every number of `names` (an env cell's by default) at or under its
    limit (a reading that is not a number fails); a number with no limit
    raises."""
    _limited(limits, names)
    return all(values[k] <= limits[k] for k in names)


def lines(values: dict, limits: dict, names=NUMBERS) -> list:
    """`<number> <reading> limit <limit>`, one line a number of `names`; a
    number with no limit raises."""
    _limited(limits, names)
    return [f'{k} {values[k]!r} limit {limits[k]!r}' for k in names]
