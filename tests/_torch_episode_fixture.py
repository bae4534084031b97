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

The 1-ulp floor is scripts/chaos_floor.py's experiment on these 64
trajectories: the episode run again from the resets with every position
moved 1 ulp, the end positions and scores compared with the unmoved
run's.  Draw 0 moves every position up, as scripts/chaos_floor.py does;
draw k > 0 moves each position coordinate up or down by `nudge_up(k)`
(RandomState(k)).  Each draw gives `dpos_stats` (scripts/chaos_floor.py's
median, 90th percentile and share within 0.05 of the per-body distance,
over the 64 envs' bodies) and the mean |score difference| over the envs.
The gate of each statistic is the GATE_QUANTILE quantile of its N_DRAWS
draws (the share within 0.05: the 1 - GATE_QUANTILE quantile).

XLA's CPU step gives an env the same bits in a call of 64 envs as in a
larger batch of such calls stacked (not in a call of one env: see
tests/_torch_episode_rounding.py), and its cost is linear in the batch, so
the runs (the unmoved one and each draw, 64 envs each) are spread over
worker processes, each pinned to one core, instead of one vmap of
64 (N_DRAWS + 1) envs.  Finished runs are kept under
build/episode_fixture/, so a run that is stopped resumes.

The npz holds, under `<task>/`:
  actions                                       (T, B) int32
  reset/<field>, step1/<field>, end/<field>     every EnvState field
  score                                         (B,) end scores
  nudge<k>/<field>   the step-1 state of the first N_NUDGED envs from the
                     reset with every position (k = 0, 1) or angle (k = 2,
                     3) moved 1 ulp up or down: the reference's own
                     one-step chaos
  trace_steps, trace_pos, trace_angle   poses at a few steps, to bisect
The json holds, for each task, each draw's statistics and the gate.

Run (about two hours on 8 CPU cores, most of it ClusterColour's draws;
name legs to rewrite only theirs):

    JAX_PLATFORMS=cpu MAGICAL_TPU_PALLAS=0 \\
        python tests/_torch_episode_fixture.py [--workers N] [TASK ...]
"""

import argparse
import dataclasses
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
GATE_QUANTILE = 0.9
ACTION_SEED = 0
HOLD = (4, 16)
STATS = ('dpos_median', 'dpos_p90', 'frac_within_0p05', 'dscore_mean')
TRACE_STEPS = (1, 2, 5, 10, 20, 40, 80, 120, 160, 200, 240)
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
    """Which position coordinates draw k moves up (the rest go down)."""
    if k == 0:
        return np.ones(shape, bool)
    return np.random.RandomState(k).randint(0, 2, shape).astype(bool)


def nudged(pos, k):
    """`pos` with every coordinate moved 1 ulp as draw k moves it."""
    pos = np.asarray(pos, np.float32)
    return np.where(nudge_up(k, pos.shape),
                    np.nextafter(pos, np.float32(np.inf)),
                    np.nextafter(pos, np.float32(-np.inf)))


def dpos_stats(pos, ref_pos):
    """scripts/chaos_floor.py:83-95's statistics of two end states."""
    dpos = np.linalg.norm(np.asarray(pos, np.float32)
                          - np.asarray(ref_pos, np.float32), axis=-1)
    return dict(dpos_median=float(np.median(dpos)),
                dpos_p90=float(np.percentile(dpos, 90)),
                frac_within_0p05=float((dpos < 0.05).mean()))


def draw_stats(pos, score, ref_pos, ref_score):
    """A draw's STATS against the unmoved run."""
    return dict(dpos_stats(pos, ref_pos), dscore_mean=float(np.mean(
        np.abs(np.asarray(score, np.float64) - ref_score))))


def gate(draws):
    """Per statistic the GATE_QUANTILE quantile of the draws
    ({statistic: [one a draw]}); the share within 0.05 the
    1 - GATE_QUANTILE quantile."""
    q = 100 * GATE_QUANTILE
    return {s: float(np.percentile(draws[s], 100 - q if s.startswith('frac')
                                   else q)) for s in STATS}


def _fields(state, prefix, out, rows=slice(None)):
    for f in dataclasses.fields(state):
        out[f'{prefix}/{f.name}'] = np.asarray(getattr(state, f.name))[rows]


def _pin(slots):
    """Pin this worker to one of the cores the writer may use."""
    if hasattr(os, 'sched_setaffinity'):
        allowed = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {allowed[slots.get() % len(allowed)]})


def run(task, draw):
    """One 64-env episode of `task` on the XLA path: the unmoved run
    (draw None), with everything the npz keeps, or draw k's, its end
    positions and scores."""
    import jax
    import jax.numpy as jnp

    from magical_tpu.core import physics as P
    from magical_tpu.tasks import ALL_TASKS

    t = ALL_TASKS[task]
    assert (t.max_blocks, t.ep_len) == LEGS[task]
    step = jax.jit(jax.vmap(P.control_step))
    acts = leg_actions(task)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    st = jax.jit(jax.vmap(lambda k: t.reset_fn(k, t.flags_for('Demo'))))(keys)
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
        st = step(st, jnp.asarray(acts[i]))
        if draw is None and i + 1 == 1:
            _fields(st, 'step1', out)
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


def part_path(task, draw):
    """Where a run is kept: named by its leg, its draw and its actions."""
    name = 'base' if draw is None else f'draw{draw}'
    key = hashlib.sha1(leg_actions(task).tobytes()).hexdigest()[:12]
    return os.path.join(PARTS, f'{task}_{name}_{key}.npz')


def run_part(unit):
    """Run one unit in a worker, keep it under PARTS, return its path."""
    task, draw = unit
    path = part_path(task, draw)
    out = run(task, draw)
    np.savez(path + '.tmp.npz', **out)
    os.replace(path + '.tmp.npz', path)
    print(f'{task} {"base" if draw is None else f"draw {draw}"} done',
          flush=True)
    return path


def main(argv=None):
    import multiprocessing as mp

    p = argparse.ArgumentParser()
    p.add_argument('tasks', nargs='*', default=list(TASKS))
    p.add_argument('--workers', type=int, default=os.cpu_count() or 1)
    args = p.parse_args(argv)
    os.makedirs(PARTS, exist_ok=True)
    units = [(task, d) for task in args.tasks
             for d in (None, *range(N_DRAWS))]
    todo = [u for u in units if not os.path.exists(part_path(*u))]
    # the longest legs first
    todo.sort(key=lambda u: -LEGS[u[0]][0] * LEGS[u[0]][1])
    if todo:
        ctx = mp.get_context('spawn')
        slots = ctx.Queue()
        for i in range(args.workers):
            slots.put(i)
        with ctx.Pool(min(args.workers, len(todo)), _pin, (slots,)) as pool:
            for _ in pool.imap_unordered(run_part, todo):
                pass
    out, floor = {}, {}
    if os.path.exists(OUT):
        with np.load(OUT) as f:
            out = {k: f[k] for k in f.files
                   if k.split('/')[0] in set(TASKS) - set(args.tasks)}
    if os.path.exists(FLOOR):
        with open(FLOOR) as f:
            floor = json.load(f)
    for task in args.tasks:
        with np.load(part_path(task, None)) as f:
            base = {k: f[k] for k in f.files}
        np.testing.assert_array_equal(base['actions'], leg_actions(task))
        out.update({f'{task}/{k}': v for k, v in base.items()})
        per_draw = []
        for d in range(N_DRAWS):
            with np.load(part_path(task, d)) as f:
                per_draw.append(draw_stats(f['pos'], f['score'],
                                           base['end/pos'], base['score']))
        draws = {s: [x[s] for x in per_draw] for s in STATS}
        floor[task] = {
            'B': B, 'n_steps': LEGS[task][1], 'max_blocks': LEGS[task][0],
            'perturb': '1 ulp on every pos coordinate; draw 0 all up, draw '
                       'k > 0 up or down by RandomState(k)',
            'n_draws': N_DRAWS, 'draws': draws, 'gate': gate(draws),
            'rule': f'per statistic the {GATE_QUANTILE} quantile of the '
                    f'draws (the share within 0.05: the '
                    f'{1 - GATE_QUANTILE:.1f} quantile)',
            'scores_above_0': int((base['score'] > 0).sum())}
        print(task, json.dumps({k: floor[task][k] for k in (
            'gate', 'scores_above_0')}), flush=True)
    np.savez_compressed(OUT, **out)
    with open(FLOOR, 'w') as f:
        json.dump({t: floor[t] for t in TASKS if t in floor}, f, indent=1)
    print(f'wrote {OUT} ({os.path.getsize(OUT)} bytes) and {FLOOR}',
          flush=True)


if __name__ == '__main__':
    main()
