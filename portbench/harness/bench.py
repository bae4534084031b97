"""One run of one cell: set-up, the window, the check, the result line.

:func:`run_cell` is the whole run but the look for a card, which
``run.py`` makes first; the harness's tests call it on the CPU.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import types

import torch

from portbench.harness import check, spec, trace, traffic, window
from portbench.reference.env import Scene

# top-level module names that must never be loaded: JAX, its libraries and
# the JAX package the port was made from (compared whole)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'magical_tpu')
# episodes the check plan draws ahead (more than any window reaches)
PLAN_EPISODES = 4096
# warm-up resets and steps draw from episodes past the plan's
WARM_EPISODE = PLAN_EPISODES
# action tables drawn before the window; episode e takes table e mod POOL
POOL = 16
# steps of the warm-up
WARM_STEPS = 3
# the host's threads, few, so that the host's load is steady
HOST_THREADS = 4
# the check: episodes it takes, rows of each it compares
CHECK_EPISODES = 3
CHECK_ROWS = 64
# the traced run counts the work of every WORK_EVERY-th step
WORK_EVERY = 8


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is in FORBIDDEN."""
    return sorted({name for name in list(sys.modules)
                   if name.split('.')[0] in FORBIDDEN})


def device_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as err:
        return f'nvidia-smi: {err}'


def make_env(cell: spec.Cell, device):
    from magical_tpu_torch.api.batched_env import BatchedEnv
    env = BatchedEnv(cell.env_id, fidelity=cell.traffic['fidelity'],
                     device=device)
    c = cell.config
    if (env.task.max_blocks, env.max_episode_steps) != (c['max_blocks'],
                                                       c['ep_len']):
        raise ValueError(
            f'{cell.env_id}: the port runs max_blocks '
            f'{env.task.max_blocks} and {env.max_episode_steps} steps, the '
            f'configuration states {c["max_blocks"]} and {c["ep_len"]}')
    return env


def warm_up(plan: window.Plan, steps: int):
    """A reset and `steps` steps of the cell's own shapes, with what the
    window keeps, outside the episodes the window runs."""
    env = plan.env
    carry, obs = env.reset(traffic.reset_generator(plan.seed, WARM_EPISODE),
                           plan.batch)
    rows = plan.check_rows[0]
    window.clone_state(carry.state)
    obs.index_select(0, rows)
    for j in range(steps):
        carry, obs, _, done, info = env.step(carry, plan.actions[j])
        window.clone_state(carry.state, rows)
        obs.index_select(0, rows)
        info['eval_score'].clone()
        done.clone()
    if env.device.type == 'cuda':
        torch.cuda.synchronize()


def traced_window(cell, plan, layers):
    """The traced window: `trace.episodes` whole episodes under the
    profiler with every layer's range, the states of every WORK_EVERY-th
    step kept for the work counts; then
    `trace.host_episodes` episodes unprofiled, each reset and step timed on
    the host's clock after a sync.  Returns (window, context)."""
    tr = cell.traffic['trace']
    every = WORK_EVERY
    kept = {}

    def keep(ep, j, carry):
        if j % every == every - 1 or j % every == 0:
            kept[(ep.index, j)] = window.clone_state(carry.state)

    env = plan.env
    with trace.wrap(layers, env):
        warm_up(plan, 2)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w = window.run(plan, math.inf, max_episodes=int(tr['episodes']),
                           span=trace.span, on_step=keep)
        with tempfile.TemporaryDirectory() as tmp:
            path = f'{tmp}/trace.json'
            prof.export_chrome_trace(path)
            t = trace.read(path)
        del prof
    # the work counts' states: the state before and after each counted
    # step (step j of an episode is the window's step index)
    work, index = [], 0
    for ep in w.episodes:
        for j in range(1, ep.steps + 1):
            index += 1
            if j % every == 0 and (ep.index, j) in kept:
                pre = (kept.get((ep.index, j - 1))
                       if j > 1 else ep.reset_state)
                if pre is not None:
                    work.append((index, check.as_reference(pre),
                                 check.as_reference(kept[(ep.index, j)])))
    host_reset, host_step = host_times(plan, int(tr['host_episodes']),
                                       first=w.resets)
    ctx = types.SimpleNamespace(
        trace=t, steps=w.steps, work=work, host_reset_s=host_reset,
        host_step_s=host_step, env=env, fidelity=cell.traffic['fidelity'])
    return w, ctx


def host_times(plan, episodes: int, first: int):
    """Host seconds of each reset (synchronised before and after) and of
    each step call (after a sync; no sync after it: the enqueue)."""
    env, L = plan.env, plan.ep_len
    sync = torch.cuda.synchronize if env.device.type == 'cuda' else \
        (lambda: None)
    resets, steps = [], []
    for e in range(first, first + episodes):
        sync()
        t = time.perf_counter()
        carry, _ = env.reset(traffic.reset_generator(plan.seed, e),
                             plan.batch)
        sync()
        resets.append(time.perf_counter() - t)
        table = (e % plan.pool) * L
        for j in range(L):
            act = plan.actions[table + j]
            sync()
            t = time.perf_counter()
            carry, *_ = env.step(carry, act)
            steps.append(time.perf_counter() - t)
    sync()
    return resets, steps


def per_layer(cell, ctx, here=spec.HERE) -> dict:
    out = {}
    for m in cell.per_layer:
        value = spec.load_metric(m['name'], here).read(ctx)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device='cuda', start: float = None, batch: int = None,
             control: bool = False, here=spec.HERE,
             episodes: int = None) -> dict:
    """One run of `cell`: the result line's dict (with the control's
    readings under ``control`` where asked).  `batch` overrides the
    traffic's and `episodes` ends the window after that many whole
    episodes (the harness's tests, on the CPU).  A traffic file with
    ``"loop": "gail"`` is a learner cell's (``harness/learner.py``)."""
    if cell.traffic.get('loop') == 'gail':
        from portbench.harness import learner
        return learner.run_cell(cell, seed, seconds, traced, device=device,
                                start=start, batch=batch, control=control,
                                here=here, episodes=episodes)
    start = time.time() if start is None else start
    device = torch.device(device)
    tr = cell.traffic
    batch = int(batch or tr['batch'])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(HOST_THREADS)
    env = make_env(cell, device)
    scene = Scene(cell.config, tr['variant'], tr['fidelity'])
    plan = window.make_plan(env, seed, batch, POOL,
                            PLAN_EPISODES, CHECK_ROWS,
                            tr['hold'])
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if traced:
        w, ctx = traced_window(cell, plan, spec.layers(here))
    else:
        warm_up(plan, WARM_STEPS)
        setup_s = time.time() - start
        w = window.run(plan, seconds, max_episodes=episodes)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f'loaded while the window ran: {found}')
    limits = tr['limits']
    values = check.readings(scene, w, plan, CHECK_EPISODES)
    result = {'correct': check.verdict(values, limits),
              'attempted': w.steps * batch, 'failed': 0}
    if traced:
        result['metrics'] = per_layer(cell, ctx, here)
    else:
        quantity = {'env_steps_per_s': window.env_steps_per_s(w),
                    'step_ms_p95': window.step_ms_p95(w),
                    'setup_s': setup_s}
        result['metrics'] = {m['name']: {'value': quantity[m['name']],
                                         'unit': m['unit']}
                             for m in cell.end_to_end}
    result['device'] = {
        'platform': 'gpu' if cuda else 'cpu',
        'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
        'count': 1, 'memory_peak_bytes': peak}
    if traced:
        t = ctx.trace
        result['device'].update(busy_s=t.busy_us / 1e6,
                                window_s=t.window_us / 1e6)
        result['breakdown'] = trace.breakdown(t)
    if control:
        result['control'] = check.readings(scene, w, plan,
                                           CHECK_EPISODES,
                                           control=True)
    result['window'] = {'seconds': w.seconds, 'steps': w.steps,
                        'resets': w.resets,
                        'step_ms_median': statistics.median(w.intervals_ms)}
    result['checks'] = {k: {'value': values[k], 'limit': limits[k]}
                        for k in check.NUMBERS}
    return result


def dumps(result: dict) -> str:
    """The result line: JSON, with infinities as strings."""
    def fix(x):
        if isinstance(x, float) and not math.isfinite(x):
            return repr(x)
        if isinstance(x, dict):
            return {k: fix(v) for k, v in x.items()}
        if isinstance(x, list):
            return [fix(v) for v in x]
        return x
    return json.dumps(fix(result))
