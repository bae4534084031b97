"""Write tests/fixtures/torch_episode_reference.npz and
tests/fixtures/torch_episode_floor.json: the whole-episode reference that
tests/test_torch_episode.py and chip_smoke.py's `[episode]` phase hold
magical_tpu_torch against, and the reference's own 1-ulp floor over it.

Three legs (LEGS), each B = 64 Demo resets from PRNGKey(0) and `ep_len`
steps of magical_tpu's XLA `control_step` (MAGICAL_TPU_PALLAS=0):
MoveToCorner (mb 1, 80 steps: the main path's kernel), MatchRegions (mb 8,
120) and ClusterColour (mb 10, 240).  Demo resets are all alike, so the
64 trajectories differ by their actions, `<task>/actions` (T, B):

  * env 0 takes scripts/chaos_floor.py's 40-action script, repeated, so
    env 0 of MatchRegions and ClusterColour is that script's own leg;
  * envs 1-63 take held actions (`held_actions`) drawn from
    numpy RandomState(ACTION_SEED), env after env: an action drawn
    uniformly from the 18, held for a number of steps drawn uniformly from
    4 to 16, then the next.  On MoveToCorner such actions leave the block
    where it lies (2 of 64 envs score), so there each env first follows
    MTC_PLAN for a number of steps drawn uniformly from 0 to 79, and
    held actions take over from then on.  MTC_PLAN is itself held actions
    that drive the robot round the block to below its right side and push
    it up and left, towards the corner; its outcome is the same in XLA's
    batched and one-env builds (28 of 64 envs score in both), where a route
    that turns against the block is not.

Each step is one call of a jitted, vmapped `control_step` from a Python
loop (a `lax.scan` over the episode takes hours to compile on the CPU).

The hold has two parts, each a set of XLA draws of a null experiment over
these 64 trajectories, written to the json:

  * the end part: scripts/chaos_floor.py's experiment, the episode run
    again from the resets with every position moved 1 ulp, its end
    positions and scores compared with the unmoved run's.  Draw 0 moves
    every position up, as scripts/chaos_floor.py does; draw k > 0 moves
    each position coordinate up or down by `nudge_up(k)` (RandomState(k)).
    Each of its N_DRAWS draws gives `dpos_stats` (the median, 90th
    percentile and share within 0.05 of the per-body distance, over the 64
    envs' bodies), held, and the mean |score difference| over the envs,
    recorded only: on MatchRegions and ClusterColour no env scores, so
    it is 0 in most runs;
  * the step part: one control step into each of the step horizons
    (`step_horizons`: steps 1, 2, 4, 8, 16, 32 and the episode's last)
    from the unmoved run's state before it, so that chaos has no steps to
    grow in.  Draw k (of N_STEP) moves pos, angle, vel and omega of that
    state by 1 ulp, each coordinate up or down as `step_signs(k)` draws
    it from RandomState(k), horizon after horizon, before the step.  Per
    horizon and field the statistic is the median over the envs of the
    largest |difference| from the unmoved step over the bodies
    (`step_stats`).  The npz keeps the unmoved run's state before each
    horizon and its pos, angle, vel and omega after it.

A candidate is held to each part by `hold` (one permutation test: the
largest log ratio of a run's statistics to the median of all runs', level
1/(draws + 1)).

XLA's CPU step gives an env the same bits in a call of 64 envs as in a
larger batch of such calls stacked (not in a call of one env: see
tests/_torch_episode_rounding.py), and its cost is linear in the batch, so
the runs (the unmoved one and each draw, 64 envs each) are spread over
worker processes, each pinned to one core, instead of one vmap of many
envs.  Finished runs are kept under build/episode_fixture/, so a run that
is stopped resumes.  The end draws are run only for a leg that the json
does not hold yet; otherwise the stored ones are kept, and the unmoved
run has to end in the bits they were taken against.

The npz holds, under `<task>/`:
  actions                                       (T, B) int32
  reset/<field>, step1/<field>, end/<field>     every EnvState field
  score                                         (B,) end scores
  nudge<k>/<field>   the step-1 state of the first N_NUDGED envs from the
                     reset with every position (k = 0, 1) or angle (k = 2,
                     3) moved 1 ulp up or down: the reference's own
                     one-step chaos
  trace_steps, trace_pos, trace_angle   the unmoved run's poses at
                     TRACE_STEPS
  before<h>/<field>  every EnvState field before step h, for the step
                     horizons but the first (before1 is reset)
  after<h>/<field>   pos, angle, vel and omega after step h, for the step
                     horizons but the last (its after is end)
The json holds, for each part, its draws' statistics per leg, the
statistics held, its level and its null, and the rule.

Run (name legs to rewrite only theirs):

    JAX_PLATFORMS=cpu MAGICAL_TPU_PALLAS=0 \\
        python tests/_torch_episode_fixture.py [--workers N] [TASK ...]
"""

import argparse
import dataclasses
import functools
import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault('MAGICAL_TPU_PALLAS', '0')

OUT = os.path.join(REPO, 'tests', 'fixtures', 'torch_episode_reference.npz')
FLOOR = os.path.join(REPO, 'tests', 'fixtures', 'torch_episode_floor.json')
PARTS = os.path.join(REPO, 'build', 'episode_fixture')
# task -> (max_blocks, episode steps); the steps are the task's ep_len
LEGS = {'MoveToCorner': (1, 80), 'MatchRegions': (8, 120),
        'ClusterColour': (10, 240)}
TASKS = tuple(LEGS)
B = 64
N_NUDGED = 8
N_DRAWS = 16
N_STEP = 64
ACTION_SEED = 0
HOLD = (4, 16)
STATS = ('dpos_median', 'dpos_p90', 'frac_within_0p05', 'dscore_mean')
END_HELD = STATS[:3]
HORIZONS = (1, 2, 4, 8, 16, 32)
STEP_FIELDS = ('pos', 'angle', 'vel', 'omega')
TRACE_STEPS = (1, 2, 5, 10, 20, 40, 80, 120, 160, 200, 240)
END_NULL = ('1 ulp on every pos coordinate of the reset; draw 0 all up, '
            'draw k > 0 up or down by RandomState(k)')
STEP_NULL = ('one control step into each step horizon from the unmoved '
             'run\'s state, moved 1 ulp on every coordinate of pos, angle, '
             'vel and omega; draw k up or down by RandomState(k), horizon '
             'after horizon, field after field in that order')
RULE = ('each statistic oriented so that higher is worse (the share within '
        '0.05 as the share beyond it); a run\'s T is the largest over the '
        'part\'s statistics of every leg of log(its value / the median of '
        'the draws + 1 runs\' values); the candidate fails if its T is '
        'above every draw\'s; level 1/(draws + 1)')
ACTION_NAMES = (
    'Open', 'UpOpen', 'DownOpen', 'LeftOpen', 'UpLeftOpen', 'DownLeftOpen',
    'RightOpen', 'UpRightOpen', 'DownRightOpen', 'Close', 'UpClose',
    'DownClose', 'LeftClose', 'UpLeftClose', 'DownLeftClose', 'RightClose',
    'UpRightClose', 'DownRightClose')
A = {n: i for i, n in enumerate(ACTION_NAMES)}
# MoveToCorner's route, (action, steps); the last is held to the end
MTC_PLAN = (('UpOpen', 6), ('LeftOpen', 6), ('UpOpen', 10), ('LeftOpen', 6),
            ('UpOpen', 4), ('LeftOpen', 6), ('UpOpen', 80))


def action_script(n_steps):
    """scripts/chaos_floor.py's action script, one action per step."""
    script = [A['UpOpen']] * 10 + [A['UpLeftOpen']] * 6 + [A['UpOpen']] * 10 \
        + [A['UpRightOpen']] * 6 + [A['UpClose']] * 8
    return [script[t % len(script)] for t in range(n_steps)]


def held_actions(rng, n_steps, plan=None):
    """One env's actions: first `plan` ((action name, steps) segments) for
    a number of steps drawn from 0 to n_steps - 1, when given; then
    actions drawn from all 18, each held for HOLD[0] to HOLD[1] steps."""
    out = []
    if plan is not None:
        out = [A[a] for a, n in plan for _ in range(n)][:rng.randint(n_steps)]
    while len(out) < n_steps:
        a = rng.randint(0, len(ACTION_NAMES))
        out += [a] * rng.randint(HOLD[0], HOLD[1] + 1)
    return out[:n_steps]


def leg_actions(task):
    """(T, B) int32: env 0 the script, envs 1.. held actions drawn from
    RandomState(ACTION_SEED) (after MTC_PLAN on MoveToCorner)."""
    n_steps = LEGS[task][1]
    rng = np.random.RandomState(ACTION_SEED)
    plan = MTC_PLAN if task == 'MoveToCorner' else None
    cols = [action_script(n_steps)] + [held_actions(rng, n_steps, plan)
                                       for _ in range(1, B)]
    return np.asarray(cols, np.int32).T.copy()


def nudge_up(k, shape):
    """Which position coordinates end draw k moves up (the rest go
    down)."""
    if k == 0:
        return np.ones(shape, bool)
    return np.random.RandomState(k).randint(0, 2, shape).astype(bool)


def ulp_moved(x, up):
    """`x` (float32) with each coordinate moved 1 ulp up where `up`, down
    elsewhere."""
    x = np.asarray(x, np.float32)
    return np.where(up, np.nextafter(x, np.float32(np.inf)),
                    np.nextafter(x, np.float32(-np.inf)))


def nudged(pos, k):
    """`pos` with every coordinate moved 1 ulp as end draw k moves it."""
    return ulp_moved(pos, nudge_up(k, np.shape(pos)))


def step_horizons(task):
    """The step part's horizons of `task`: HORIZONS and the last step."""
    return HORIZONS + (LEGS[task][1],)


def step_signs(k, shapes, n):
    """Step draw k's nudges: for each of `n` horizons, {field: which
    coordinates move up} for STEP_FIELDS, drawn from RandomState(k)
    horizon after horizon and field after field (`shapes`: {field: shape},
    alike at every horizon)."""
    rng = np.random.RandomState(k)
    for _ in range(n):
        yield {f: rng.randint(0, 2, shapes[f]).astype(bool)
               for f in STEP_FIELDS}


def dpos_stats(pos, ref_pos):
    """scripts/chaos_floor.py:83-95's statistics of two end states."""
    dpos = np.linalg.norm(np.asarray(pos, np.float32)
                          - np.asarray(ref_pos, np.float32), axis=-1)
    return dict(dpos_median=float(np.median(dpos)),
                dpos_p90=float(np.percentile(dpos, 90)),
                frac_within_0p05=float((dpos < 0.05).mean()))


def draw_stats(pos, score, ref_pos, ref_score):
    """An end-part run's STATS against the unmoved run."""
    return dict(dpos_stats(pos, ref_pos), dscore_mean=float(np.mean(
        np.abs(np.asarray(score, np.float64) - ref_score))))


def step_maxima(after, ref_after):
    """{field: (B,) the largest |difference| over the env's coordinates}
    of one step's pos, angle, vel and omega against the unmoved step's."""
    out = {}
    for f in STEP_FIELDS:
        d = np.abs(np.asarray(after[f], np.float64)
                   - np.asarray(ref_after[f], np.float64))
        out[f] = d.reshape(d.shape[0], -1).max(1)
    return out


def step_stats(maxima):
    """A step-part run's statistics from its step_maxima at each horizon
    ({h: {field: (B,)}}): per horizon and field the median over the
    envs."""
    return {f'{f}_h{h}': float(np.median(m[f]))
            for h, m in maxima.items() for f in STEP_FIELDS}


def step_pair(data, task, h):
    """The unmoved run's step into horizon h from the npz: ({field: numpy}
    of the state before it, the (B,) actions, {field: numpy} of pos,
    angle, vel and omega after it)."""
    last = LEGS[task][1]
    before = 'reset' if h == 1 else f'before{h}'
    after = 'end' if h == last else f'after{h}'
    n = len(f'{task}/{before}/')
    state = {k[n:]: v for k, v in data.items()
             if k.startswith(f'{task}/{before}/')}
    return (state, data[f'{task}/actions'][h - 1],
            {f: data[f'{task}/{after}/{f}'] for f in STEP_FIELDS})


def worse_first(stat, x):
    """`x` oriented so that higher is worse: the share within 0.05 as the
    share beyond it; NaN (a run that blew up) is the worst."""
    x = np.asarray(x, np.float64)
    if stat.split('/')[-1].startswith('frac'):
        x = 1 - x
    return np.where(np.isnan(x), np.inf, x)


def mid_ranks(x):
    """Mid-ranks (1 = least) along the last axis, ties averaged."""
    x = np.asarray(x)
    less = (x[..., None, :] < x[..., :, None]).sum(-1)
    same = (x[..., None, :] == x[..., :, None]).sum(-1)
    return less + (same + 1) / 2


def log_ratios(runs):
    """log(value / the median over the runs) of (S, R) oriented
    statistics: 0 where a value equals the median, +inf where the median
    is 0 and the value is not."""
    med = np.median(runs, -1, keepdims=True)
    with np.errstate(divide='ignore', invalid='ignore'):
        return np.where(runs == med, 0.0, np.log(runs / med))


def hold(candidate, draws):
    """The hold of one part: `candidate` {statistic: value} against
    `draws` {statistic: [one a draw]} (the statistics of every leg of the
    part, named '<task>/<stat>').  Every run of the D + 1 gets, in each
    statistic, the log of its value over the median of the D + 1 values,
    the worse the higher; T is a run's largest.  The candidate fails if
    its T is above every draw's (ties pass): a candidate exchangeable with
    the draws fails with probability at most 1/(D + 1).  Returns {passed,
    T, T_draws_max, level, ratios, ranks}: the candidate's log ratio and
    mid-rank in each statistic."""
    names = sorted(draws)
    runs = np.stack([worse_first(s, np.concatenate(
        [[candidate[s]], draws[s]])) for s in names])
    lr = log_ratios(runs)
    t = lr.max(0)
    return dict(passed=bool(t[0] <= t[1:].max()), T=float(t[0]),
                T_draws_max=float(t[1:].max()), level=1 / runs.shape[1],
                ratios={s: float(r) for s, r in zip(names, lr[:, 0])},
                ranks={s: float(r) for s, r in zip(
                    names, mid_ranks(runs)[:, 0])})


def draws_T(draws):
    """Each draw's T among the draws alone (no candidate)."""
    names = sorted(draws)
    runs = np.stack([worse_first(s, draws[s]) for s in names])
    return log_ratios(runs).max(0).tolist()


def part_draws(floor, part, tasks=TASKS):
    """{'<task>/<stat>': [one a draw]} of the statistics `part` ('end' or
    'step') holds: all its draws' but those it only records."""
    recorded = floor[part].get('recorded', [])
    return {f'{t}/{s}': v for t in tasks
            for s, v in floor[part]['legs'][t]['draws'].items()
            if s not in recorded}


def _fields(state, prefix, out, rows=slice(None)):
    for f in dataclasses.fields(state):
        out[f'{prefix}/{f.name}'] = np.asarray(getattr(state, f.name))[rows]


def _pin(slots):
    """Pin this worker to one of the cores the writer may use."""
    if hasattr(os, 'sched_setaffinity'):
        allowed = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {allowed[slots.get() % len(allowed)]})


@functools.lru_cache(maxsize=None)
def _step():
    import jax

    from magical_tpu.core import physics as P
    return jax.jit(jax.vmap(P.control_step))


def leg_reset(task):
    """The leg's 64 Demo resets from PRNGKey(0), on XLA."""
    import jax

    from magical_tpu.tasks import ALL_TASKS
    t = ALL_TASKS[task]
    assert (t.max_blocks, t.ep_len) == LEGS[task]
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    return jax.jit(jax.vmap(lambda k: t.reset_fn(k, t.flags_for('Demo'))))(
        keys)


def run(task, draw):
    """One 64-env episode of `task` on the XLA path: the unmoved run
    (draw None), with everything the npz keeps, or end draw k's, its end
    positions and scores."""
    import jax
    import jax.numpy as jnp

    from magical_tpu.tasks import ALL_TASKS

    t = ALL_TASKS[task]
    step = _step()
    acts = leg_actions(task)
    st = leg_reset(task)
    horizons = step_horizons(task)
    out = {}
    if draw is None:
        _fields(st, 'reset', out)
        a0 = jnp.asarray(acts[0])
        for k, (f, d) in enumerate((('pos', np.inf), ('pos', -np.inf),
                                    ('angle', np.inf), ('angle', -np.inf))):
            x = np.nextafter(np.asarray(getattr(st, f)), np.float32(d))
            _fields(step(st.replace(**{f: jnp.asarray(x)}), a0),
                    f'nudge{k}', out, slice(0, N_NUDGED))
    else:
        st = st.replace(pos=jnp.asarray(nudged(st.pos, draw)))
    trace = [s for s in TRACE_STEPS if s <= t.ep_len]
    tpos, tang = [], []
    for i in range(t.ep_len):
        if draw is None and i + 1 in horizons[1:]:
            _fields(st, f'before{i + 1}', out)
        st = step(st, jnp.asarray(acts[i]))
        if draw is None and i + 1 == 1:
            _fields(st, 'step1', out)
        if draw is None and i + 1 in horizons[:-1]:
            out.update({f'after{i + 1}/{f}': np.asarray(getattr(st, f))
                        for f in STEP_FIELDS})
        if draw is None and i + 1 in trace:
            tpos.append(np.asarray(st.pos))
            tang.append(np.asarray(st.angle))
    score = np.asarray(jax.vmap(t.score_fn)(st))
    if draw is None:
        _fields(st, 'end', out)
        out.update(score=score, trace_steps=np.asarray(trace, np.int32),
                   trace_pos=np.stack(tpos), trace_angle=np.stack(tang),
                   actions=acts)
    else:
        out.update(pos=np.asarray(st.pos), score=score)
    return out


def run_step(task, k, data):
    """Step draw k of `task`: at each step horizon one XLA step from the
    unmoved run's state in `data` (the npz's arrays) moved by
    step_signs(k); {field: (H, B)} its step_maxima against the unmoved
    step."""
    import jax.numpy as jnp

    step = _step()
    st = leg_reset(task)
    horizons = step_horizons(task)
    shapes = {f: np.shape(getattr(st, f)) for f in STEP_FIELDS}
    out = {f: [] for f in STEP_FIELDS}
    for h, up in zip(horizons, step_signs(k, shapes, len(horizons))):
        before, act, after = step_pair(data, task, h)
        moved = dict(before, **{f: ulp_moved(before[f], up[f])
                                for f in STEP_FIELDS})
        nxt = step(st.replace(**{n: jnp.asarray(v)
                                 for n, v in moved.items()}),
                   jnp.asarray(act))
        m = step_maxima({f: getattr(nxt, f) for f in STEP_FIELDS}, after)
        for f in STEP_FIELDS:
            out[f].append(m[f])
    return {f: np.stack(v) for f, v in out.items()}


def part_path(task, unit):
    """Where a run is kept: named by its leg, its kind and draw and its
    actions (`unit` None for the unmoved run, k for end draw k,
    ('step', k) for step draw k, or a name)."""
    name = ('base' if unit is None else f'draw{unit}'
            if isinstance(unit, int) else f'step{unit[1]}'
            if isinstance(unit, tuple) else unit)
    key = hashlib.sha1(leg_actions(task).tobytes()).hexdigest()[:12]
    return os.path.join(PARTS, f'{task}_{name}_{key}.npz')


def run_part(job):
    """Run one job (task, unit) in a worker, keep it under PARTS, return
    its path."""
    task, unit = job
    path = part_path(task, unit)
    if isinstance(unit, tuple):
        with np.load(part_path(task, None)) as f:
            out = run_step(task, unit[1],
                           {f'{task}/{n}': f[n] for n in f.files})
    else:
        out = run(task, unit)
    np.savez(path + '.tmp.npz', **out)
    os.replace(path + '.tmp.npz', path)
    print(f'{task} {os.path.basename(path)} done', flush=True)
    return path


def _cost(job):
    task, unit = job
    steps = len(HORIZONS) + 1 if isinstance(unit, tuple) else LEGS[task][1]
    return LEGS[task][0] * steps


def _pool(jobs, workers):
    """Run `jobs` not kept yet in one-core worker processes, the longest
    first."""
    import multiprocessing as mp

    todo = sorted((j for j in jobs if not os.path.exists(part_path(*j))),
                  key=lambda j: -_cost(j))
    if not todo:
        return
    ctx = mp.get_context('spawn')
    slots = ctx.Queue()
    for i in range(workers):
        slots.put(i)
    with ctx.Pool(min(workers, len(todo)), _pin, (slots,)) as pool:
        for _ in pool.imap_unordered(run_part, todo, chunksize=1):
            pass


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('tasks', nargs='*', default=list(TASKS))
    p.add_argument('--workers', type=int, default=os.cpu_count() or 1)
    args = p.parse_args(argv)
    os.makedirs(PARTS, exist_ok=True)
    out, floor = {}, {}
    if os.path.exists(OUT):
        with np.load(OUT) as f:
            out = {k: f[k] for k in f.files}
    if os.path.exists(FLOOR):
        with open(FLOOR) as f:
            floor = json.load(f)
    for part in ('end', 'step'):
        floor.setdefault(part, {}).setdefault('legs', {})
    stored = {t for t in args.tasks
              if 'draws' in floor['end']['legs'].get(t, {})}
    _pool([(t, None) for t in args.tasks]
          + [(t, d) for t in args.tasks if t not in stored
             for d in range(N_DRAWS)], args.workers)
    _pool([(t, ('step', k)) for t in args.tasks for k in range(N_STEP)],
          args.workers)
    for task in args.tasks:
        with np.load(part_path(task, None)) as f:
            base = {k: f[k] for k in f.files}
        np.testing.assert_array_equal(base['actions'], leg_actions(task))
        if task in stored:
            # the stored end draws were taken against the same unmoved run
            for k in [k for k in out if k.startswith(f'{task}/end/')]:
                np.testing.assert_array_equal(
                    base[k.split('/', 1)[1]], out[k], err_msg=k)
        out = {k: v for k, v in out.items() if k.split('/')[0] != task}
        out.update({f'{task}/{k}': v for k, v in base.items()})
        leg = floor['end']['legs'].setdefault(task, {})
        leg.update(B=B, n_steps=LEGS[task][1], max_blocks=LEGS[task][0],
                   scores_above_0=int((base['score'] > 0).sum()))
        if task not in stored:
            per_draw = []
            for d in range(N_DRAWS):
                with np.load(part_path(task, d)) as f:
                    per_draw.append(draw_stats(f['pos'], f['score'],
                                               base['end/pos'],
                                               base['score']))
            leg['draws'] = {s: [x[s] for x in per_draw] for s in STATS}
        per_draw = []
        for k in range(N_STEP):
            with np.load(part_path(task, ('step', k))) as f:
                per_draw.append(step_stats({h: {g: f[g][i] for g in f.files}
                                            for i, h in enumerate(
                                                step_horizons(task))}))
        floor['step']['legs'][task] = {
            'horizons': list(step_horizons(task)),
            'draws': {s: [x[s] for x in per_draw] for s in per_draw[0]}}
        print(task, 'scores above 0:', leg['scores_above_0'], flush=True)
    floor['end'].update(n_draws=N_DRAWS, stats=list(STATS),
                        recorded=[s for s in STATS if s not in END_HELD],
                        null=END_NULL, level=1 / (N_DRAWS + 1))
    floor['step'].update(n_draws=N_STEP, fields=list(STEP_FIELDS),
                         null=STEP_NULL, level=1 / (N_STEP + 1))
    for part in ('end', 'step'):
        legs = floor[part]['legs']
        floor[part]['legs'] = {t: legs[t] for t in TASKS if t in legs}
        if set(legs) == set(TASKS):
            floor[part]['T_draws'] = draws_T(part_draws(floor, part))
    floor['rule'] = RULE
    np.savez_compressed(OUT, **out)
    with open(FLOOR, 'w') as f:
        json.dump({k: floor[k] for k in ('rule', 'end', 'step')}, f,
                  indent=1)
    print(f'wrote {OUT} ({os.path.getsize(OUT)} bytes) and {FLOOR}',
          flush=True)


if __name__ == '__main__':
    main()
