#!/usr/bin/env python3
"""Drive the PyTorch port (magical_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

  1. device  — requires a CUDA card; prints its name and power limit.
  2. build   — compiles each csrc/*.cu with its own nvcc for sm_90a into
               build/, all at once.
  3. kernels — each kernel against its plain PyTorch version on the card,
               at B = 512, on states from seeded random-action rollouts of
               MoveToCorner-Demo, MoveToCorner-TestAll (every block shape,
               randomised dynamics) and MoveToRegion-TestAll (active
               goals): the control step (1 and 5 steps), the lo render
               into a ring slot and into a fresh frame, and, on the Test
               states, the hi render into a ring slot and into a fresh
               frame (allo and ego views); the hi render at 384² on 4
               MoveToRegion-TestAll states; and the slice on the card
               against the slice on the CPU.
  4. main    — MoveToCorner-Demo-LoRes4E-v0 at 4096 envs: reset, then a
               full 80-step episode with seeded random actions, counting
               kernel launches and timing the steps with CUDA events;
               then, from the episode's last state, each kernel against
               its plain version at the main path's shapes (one control
               step; allo and ego frames), and both timed there.
  5. hi      — MoveToCorner-TestAll-LoRes4E-v0 at hi fidelity, 1024 envs:
               reset and a full 80-step episode through the control step
               and the hi render, counted and timed as `main` is.
  6. gym     — MoveToRegion-TestAll-v0 through the registry's batch-1 Gym
               adapter at hi fidelity on the card: raw 384² {allo, ego}
               observations, a full 40-step episode, render() and the
               end-of-episode score.
  7. times   — the hi render kernel and its plain version at the hi
               path's shapes.

The last two lines of standard output are one JSON object per kernel
table and the result line {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ENV_NAME = 'MoveToCorner-Demo-LoRes4E-v0'
TEST_ENV_NAMES = ('MoveToCorner-TestAll-LoRes4E-v0',
                  'MoveToRegion-TestAll-LoRes4E-v0')
HI_ENV_NAME = 'MoveToCorner-TestAll-LoRes4E-v0'
GYM_ENV_NAME = 'MoveToRegion-TestAll-v0'
MAIN_BATCH = 4096
HI_BATCH = 1024
CHECK_BATCH = 512
RAW_CHECK_BATCH = 4
SEED = 0
DEVICE = 'cuda'

# Tolerances, kernel against plain version on the same inputs.
#  * Physics is chaotic: the plain version's own 1-ulp change of every
#    position moves poses by up to ~1e-4 in one step and ~1e-3..1e-2 in
#    five in its most sensitive envs, and its velocities far more
#    (tests/fixtures/chaos_floor.json has the reference's episode-long
#    figures).  The kernel is built without FMA contraction and rounds as
#    the plain version does, except where the plain version's per-body
#    impulse sums (scatter_add_, atomics on CUDA) add in another order;
#    the solver grows those ulps in its chaotic envs.  So the kernel is
#    held to the plain version's own 1-ulp divergence, env by env in
#    distribution:
#    - the median and 90th-percentile env must agree within the larger of
#      PHYS_FLOOR and CHAOS_FACTOR x the same percentile of the 1-ulp
#      divergence (a systematic error moves most envs);
#    - after 1 step the worst env must agree within the larger of the
#      floor and CHAOS_FACTOR x the worst 1-ulp divergence;
#    - after 5 steps the share of envs off by more than 10 floors may be
#      at most the larger of TAIL_SHARE and CHAOS_FACTOR x the share of
#      envs the 1-ulp change moves that far (the chaotic tail).
#  * Rendering: within 1 uint8 level everywhere (rounding of the AA
#    coverage at quantisation boundaries).
#  * Hi rendering: fills have hard edges, so one subpixel whose SDF rounds
#    to the other sign moves an output value by up to 16 levels; the
#    kernel repeats the plain version's operations in its order and is
#    expected byte-equal.  Held to at most one such subpixel (16 levels)
#    in at most 1e-5 of the channel values.
PHYS_FLOOR = {'pos': 1e-4, 'angle': 1e-4, 'vel': 1e-3, 'omega': 1e-3,
              'con_jn': 1e-3, 'con_jt': 1e-3, 'joint_acc': 1e-3}
CHAOS_FACTOR = 2.0
TAIL_SHARE = 0.05
RENDER_MAX_LEVELS = 1
HI_MAX_LEVELS = 16
HI_MAX_SHARE = 1e-5


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds of fn() on the card, CUDA events over reps."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f'[device] nvidia-smi: {smi}')
    print(f'[device] torch {torch.__version__} cuda {torch.version.cuda} '
          f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')
    return smi


def phase_build():
    from magical_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library(verbose=True)
    dt = time.perf_counter() - t0
    print(f'[build] nvcc {" ".join(_build.NVCC_FLAGS)}: {dt:.3f} s '
          f'(nvcc alone {_build.BUILD_SECONDS} s) -> {_build.BUILD_DIR}')
    return dt


def rollout_states(batch, n_steps, name=ENV_NAME):
    """A state of env `name` after n_steps seeded random actions, and the
    next actions."""
    import torch
    from magical_tpu_torch.api.batched_env import BatchedEnv
    env = BatchedEnv(name, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    carry, _ = env.reset(SEED, batch)
    for _ in range(n_steps):
        act = torch.randint(0, 18, (batch,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
        carry, *_ = env.step(carry, act)
    nxt = torch.randint(0, 18, (5, batch), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    return env, carry.state.clone(), nxt


def phys_compare(state0, actions, n_steps):
    """Kernel vs plain vs plain-with-1-ulp-perturbed-positions after
    n_steps; raises if the kernel is outside the tolerance."""
    import torch
    from magical_tpu_torch.core import physics, physics_kernel
    sk = state0.clone()
    sp = state0.clone()
    sc = state0.clone()
    sc.pos = torch.nextafter(sc.pos, torch.full_like(sc.pos, float('inf')))
    for i in range(n_steps):
        sk = physics_kernel.control_step(sk, actions[i])
        sp = physics.control_step(sp, actions[i])
        sc = physics.control_step(sc, actions[i])
    torch.cuda.synchronize()
    report = {}
    for f, floor in PHYS_FLOOR.items():
        k, p, c = (getattr(s, f).double().reshape(state0.batch, -1)
                   for s in (sk, sp, sc))
        err = (k - p).abs().amax(1)
        chaos = (c - p).abs().amax(1)
        q = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=torch.float64,
                         device=err.device)
        eq = torch.quantile(err, q).tolist()
        cq = torch.quantile(chaos, q).tolist()
        ok = all(eq[i] <= max(floor, CHAOS_FACTOR * cq[i]) for i in (0, 1))
        if n_steps == 1:
            tol = max(floor, CHAOS_FACTOR * cq[3])
            ok = ok and eq[3] <= tol
            rule = f'max <= {tol:.3e}'
        else:
            share = float((err > 10 * floor).double().mean())
            c_share = float((chaos > 10 * floor).double().mean())
            tol = max(TAIL_SHARE, CHAOS_FACTOR * c_share)
            ok = ok and share <= tol
            rule = f'share > 10 floors {share:.3%} <= {tol:.3%}'
        line = (f'K1 B={state0.batch} {n_steps}-step {f:9s} err '
                'p50/p90/p99/max ' + '/'.join(f'{x:.2e}' for x in eq)
                + '  1-ulp chaos '
                + '/'.join(f'{x:.2e}' for x in cq) + f'  {rule}')
        if not ok:
            raise AssertionError(line + f'; floor {floor:.1e}')
        report[f] = eq[3]
        print('[kernels] ' + line)
    cid = float((sk.con_id != sp.con_id).any(1).double().mean())
    cid_chaos = float((sc.con_id != sp.con_id).any(1).double().mean())
    cid_tol = max(0.01 if n_steps == 1 else TAIL_SHARE,
                  CHAOS_FACTOR * cid_chaos)
    print(f'[kernels] K1 B={state0.batch} {n_steps}-step con_id differs in '
          f'{cid:.3%} of envs '
          f'(1-ulp chaos {cid_chaos:.3%}, tol {cid_tol:.3%})')
    if cid > cid_tol:
        raise AssertionError('K1 con_id differs in too many envs')
    if not torch.equal(sk.t, sp.t):
        raise AssertionError('K1 step counters differ')
    return report['pos']


def render_compare(env, state):
    """K2 (into a ring slot) and K3 (fresh frame) against the plain lo
    render, allo and ego; returns the max level difference of each."""
    import torch
    from magical_tpu_torch.core import preproc, render, render_kernel
    args = (env.task.max_blocks, env.task.max_goals, env.robot_first)
    worst = {'K2': 0, 'K3': 0}
    B = state.batch
    for view in ('allo', 'ego'):
        plain = render.render_views(state, *args, views=(view,),
                                    fidelity='lo',
                                    static_shapes=env.static_shapes)[view]
        k3 = render_kernel.render_views_lo(
            state, *args, views=(view,),
            static_shapes=env.static_shapes)[view]
        spec = preproc.PreprocSpec(None, **{f'{view}_frames': 4})
        ring = torch.zeros((4, B, 96, 96, 3), dtype=torch.uint8,
                           device=DEVICE)
        t = 6
        render_kernel.render_into_slots(state, {view: ring}, t, *args, spec,
                                        static_shapes=env.static_shapes)
        torch.cuda.synchronize()
        others = [s for s in range(4) if s != t % 4]
        if int(ring[others].abs().max()) != 0:
            raise AssertionError(f'K2 {view} wrote outside slot {t % 4}')
        for name, got in (('K3', k3), ('K2', ring[t % 4])):
            d = (got.int() - plain.int()).abs()
            mx, frac = int(d.max()), float((d > 0).float().mean())
            print(f'[kernels] {name} B={B} {view}: max |diff| {mx} levels, '
                  f'{frac:.4%} of channel values differ')
            if mx > RENDER_MAX_LEVELS:
                raise AssertionError(f'{name} {view}: {mx} levels > '
                                     f'{RENDER_MAX_LEVELS}')
            worst[name] = max(worst[name], mx)
    return worst


def first_envs(state, n):
    """The first n envs of a batched state."""
    import dataclasses
    return type(state)(**{f.name: getattr(state, f.name)[:n].contiguous()
                          for f in dataclasses.fields(state)})


def hi_diff(name, got, plain, where):
    """Max level difference and share of differing channel values of a K4
    frame against the plain hi render; raises outside the tolerance."""
    d = (got.int() - plain.int()).abs()
    mx, frac = int(d.max()), float((d > 0).double().mean())
    print(f'[{where}] {name}: max |diff| {mx} levels, {frac:.3e} of '
          f'channel values differ')
    if mx > HI_MAX_LEVELS or frac > HI_MAX_SHARE:
        raise AssertionError(f'{name}: {mx} levels on {frac:.3e} of values '
                             f'> {HI_MAX_LEVELS} on {HI_MAX_SHARE}')
    return mx


def hi_compare(env, state, res):
    """K4 into a ring slot and into a fresh frame against the plain hi
    render at `res`, allo and ego; returns the max level difference."""
    import torch
    from magical_tpu_torch.core import preproc, render, render_kernel
    args = (env.task.max_blocks, env.task.max_goals, env.robot_first)
    ss = env.static_shapes
    B = state.batch
    worst = 0
    for view in ('allo', 'ego'):
        plain = render.render_views(state, *args, res=res, views=(view,),
                                    fidelity='hi', static_shapes=ss)[view]
        fresh = render_kernel.render_views_hi(
            state, *args, res=res, views=(view,), static_shapes=ss)[view]
        spec = preproc.PreprocSpec(None, res=res, **{f'{view}_frames': 4})
        ring = torch.zeros((4, B, res, res, 3), dtype=torch.uint8,
                           device=DEVICE)
        t = 5
        render_kernel.render_hi_into_slots(state, {view: ring}, t, *args,
                                           spec, res=res, static_shapes=ss)
        torch.cuda.synchronize()
        others = [k for k in range(4) if k != t % 4]
        if int(ring[others].abs().max()) != 0:
            raise AssertionError(f'K4 {view} wrote outside slot {t % 4}')
        for name, got in (('frame', fresh), ('slot', ring[t % 4])):
            worst = max(worst, hi_diff(f'K4 {name} B={B} {res}² {view}', got,
                                       plain, 'kernels'))
    return worst


def slice_compare():
    """The slice on the card against the same slice on the CPU, which the
    CPU tests hold against the JAX package: 4 envs, 8 steps of actions
    that keep them free of contacts, where the two agree to rounding."""
    import torch
    from magical_tpu_torch import constants as C
    from magical_tpu_torch.api.batched_env import BatchedEnv
    acts = torch.tensor([C.ACTION_NAMES.index(a) for a in (
        'UpOpen', 'RightOpen', 'LeftClose', 'DownClose')], dtype=torch.int32)
    out = {}
    for dev in ('cpu', DEVICE):
        env = BatchedEnv(ENV_NAME, device=dev)
        carry, obs = env.reset(SEED, len(acts))
        for _ in range(8):
            carry, obs, *_ = env.step(carry, acts.to(dev))
        out[dev] = (carry.state.pos.cpu(), obs.cpu().int())
    dpos = float((out[DEVICE][0] - out['cpu'][0]).abs().max())
    dobs = int((out[DEVICE][1] - out['cpu'][1]).abs().max())
    print(f'[kernels] slice on the card vs on the CPU, 4 envs x 8 steps: '
          f'pos {dpos:.2e}, obs {dobs} levels')
    if dpos > PHYS_FLOOR['pos'] or dobs > RENDER_MAX_LEVELS:
        raise AssertionError('the slice on the card left the CPU slice')


def phase_kernels():
    """Returns K4's max level difference."""
    k4 = 0
    for name in (ENV_NAME,) + TEST_ENV_NAMES:
        env, state0, actions = rollout_states(CHECK_BATCH, 4, name)
        print(f'[kernels] states of {name}, B={CHECK_BATCH}')
        phys_compare(state0, actions, 1)
        phys_compare(state0, actions, 5)
        render_compare(env, state0)
        if name != ENV_NAME:
            k4 = max(k4, hi_compare(env, state0, 96))
    # raw observations: 384² frames, a 1536² subpixel grid
    k4 = max(k4, hi_compare(env, first_envs(state0, RAW_CHECK_BATCH), 384))
    slice_compare()
    return k4


def phase_main_shapes(env, carry):
    """Each kernel against its plain version at the main path's shapes,
    from the main path's last state; returns the max errors."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    act = torch.randint(0, 18, (1, carry.state.batch), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    return {'K1': phys_compare(carry.state.clone(), act, 1),
            **render_compare(env, carry.state)}


def phase_main(smi):
    import torch
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.core import (physics_kernel, render,
                                        render_kernel)
    env = BatchedEnv(ENV_NAME, device=DEVICE)
    B = MAIN_BATCH
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    actions = torch.randint(0, 18, (env.max_episode_steps, B),
                            generator=gen, device=DEVICE, dtype=torch.int32)
    warm = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    counters = (physics_kernel.control_step, render_kernel.render_into_slots,
                render_kernel.render_views_lo)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    carry, obs = env.reset(SEED, B)
    dones, scores = [], []
    for t in range(env.max_episode_steps):
        if t == warm:
            start.record()
        carry, obs, rew, done, info = env.step(carry, actions[t])
        dones.append(done)
        scores.append(info['eval_score'])
    end.record()
    torch.cuda.synchronize()
    launches = {'K1': physics_kernel.control_step.launches,
                'K2': render_kernel.render_into_slots.launches,
                'K3': render_kernel.render_views_lo.launches}
    ms = start.elapsed_time(end)
    steps = env.max_episode_steps - warm
    rate = B * steps / (ms / 1e3)
    print(f'[main] {ENV_NAME} B={B}: {steps} steady steps in {ms:.3f} ms '
          f'({ms / steps:.3f} ms/step) = {rate:.1f} env-steps/s '
          f'on {smi}')
    print(f'[main] launches {launches}')

    # what came out
    if tuple(obs.shape) != (B, 96, 96, 12) or obs.dtype != torch.uint8:
        raise AssertionError(f'obs {tuple(obs.shape)} {obs.dtype}')
    done = torch.stack(dones)                         # (80, B)
    if bool(done[:-1].any()) or not bool(done[-1].all()):
        raise AssertionError('done is not true exactly at t = 80')
    score = scores[-1]
    if not (bool(torch.isfinite(score).all())
            and float(score.min()) >= 0.0 and float(score.max()) <= 1.0):
        raise AssertionError('scores outside [0, 1]')
    if any(float(s.abs().max()) != 0.0 for s in scores[:-1]):
        raise AssertionError('eval_score nonzero before the last step')
    if not (launches['K1'] == 80 and launches['K2'] == 80
            and launches['K3'] >= 1):
        raise AssertionError(f'kernel launches {launches}')
    newest = obs[..., 9:12]
    plain = render.render_views(carry.state, env.task.max_blocks,
                                env.task.max_goals, env.robot_first,
                                views=('ego',), fidelity='lo',
                                static_shapes=env.static_shapes)['ego']
    d = int((newest.int() - plain.int()).abs().max())
    if d > RENDER_MAX_LEVELS:
        raise AssertionError(f'newest obs frame vs plain render: {d}')
    print(f'[main] obs {tuple(obs.shape)} uint8; done only at t=80; score '
          f'mean {float(score.mean()):.6f} in [0, 1]; newest frame vs plain '
          f'render {d} levels')
    return env, carry, launches, rate


def phase_times(env, carry):
    """Each kernel and its plain version at the main path's shapes."""
    import torch
    from magical_tpu_torch.core import (physics, physics_kernel, preproc,
                                        render, render_kernel)
    state = carry.state.clone()
    B = state.batch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    act = torch.randint(0, 18, (B,), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    args = (env.task.max_blocks, env.task.max_goals, env.robot_first)
    ss = env.static_shapes
    spec = env.preproc
    ring = {'ego': carry.frames['ego'].clone()}
    times = {
        'K1': (cuda_ms(lambda: physics_kernel.control_step(state, act), 10),
               cuda_ms(lambda: physics.control_step(state, act), 2)),
        'K2': (cuda_ms(lambda: render_kernel.render_into_slots(
                   state, ring, 7, *args, spec, static_shapes=ss), 20),
               cuda_ms(lambda: preproc.push_frames_cf(
                   spec, ring, render.render_views(
                       state, *args, views=('ego',), fidelity='lo',
                       static_shapes=ss), 7), 3)),
        'K3': (cuda_ms(lambda: render_kernel.render_views_lo(
                   state, *args, views=('ego',), static_shapes=ss), 20),
               cuda_ms(lambda: render.render_views(
                   state, *args, views=('ego',), fidelity='lo',
                   static_shapes=ss), 3)),
    }
    for k, (ms, plain_ms) in times.items():
        print(f'[times] {k} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} '
              f'ms')
    # K2/K3 times include building the display list in plain PyTorch,
    # as their plain versions do; this is that share alone.
    disp_ms = cuda_ms(lambda: render_kernel.kernel_display(
        state, *args, static_shapes=ss), 20)
    print(f'[times] display list build (inside K2/K3 times) B={B}: '
          f'{disp_ms:.4f} ms')
    disp = render_kernel.kernel_display(state, *args, static_shapes=ss)
    slot = ring['ego'][7 % spec.depth('ego')]
    kern_ms = cuda_ms(lambda: render_kernel._launch(
        'render_lo_into_slot', disp, state, slot, 'ego', 96), 50)
    print(f'[times] lo render kernel alone (display list built) B={B}: '
          f'{kern_ms:.4f} ms')
    return times


def phase_hi(smi):
    """The hi-fidelity evaluation path: HI_ENV_NAME at HI_BATCH envs, a
    whole episode through K1 and K4."""
    import torch
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.core import physics_kernel, render, render_kernel
    env = BatchedEnv(HI_ENV_NAME, fidelity='hi', device=DEVICE)
    B = HI_BATCH
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    actions = torch.randint(0, 18, (env.max_episode_steps, B),
                            generator=gen, device=DEVICE, dtype=torch.int32)
    warm = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    counters = (physics_kernel.control_step, render_kernel.render_into_slots,
                render_kernel.render_views_lo, render_kernel.render_views_hi,
                render_kernel.render_hi_into_slots)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    carry, obs = env.reset(SEED, B)
    place_fail = int(carry.state.place_fail.sum())
    dones, scores = [], []
    for t in range(env.max_episode_steps):
        if t == warm:
            start.record()
        carry, obs, rew, done, info = env.step(carry, actions[t])
        dones.append(done)
        scores.append(info['eval_score'])
    end.record()
    torch.cuda.synchronize()
    launches = {'K1': physics_kernel.control_step.launches,
                'K2': render_kernel.render_into_slots.launches,
                'K3': render_kernel.render_views_lo.launches,
                'K4 frame': render_kernel.render_views_hi.launches,
                'K4 slot': render_kernel.render_hi_into_slots.launches}
    ms = start.elapsed_time(end)
    steps = env.max_episode_steps - warm
    rate = B * steps / (ms / 1e3)
    print(f'[hi] {HI_ENV_NAME} fidelity=hi B={B}: {steps} steady steps in '
          f'{ms:.3f} ms ({ms / steps:.3f} ms/step) = {rate:.1f} '
          f'env-steps/s on {smi}')
    print(f'[hi] launches {launches}; placement failures at reset '
          f'{place_fail} of {B} envs')

    if tuple(obs.shape) != (B, 96, 96, 12) or obs.dtype != torch.uint8:
        raise AssertionError(f'hi obs {tuple(obs.shape)} {obs.dtype}')
    done = torch.stack(dones)
    if bool(done[:-1].any()) or not bool(done[-1].all()):
        raise AssertionError('hi: done is not true exactly at t = 80')
    score = scores[-1]
    if not (bool(torch.isfinite(score).all())
            and float(score.min()) >= 0.0 and float(score.max()) <= 1.0):
        raise AssertionError('hi: scores outside [0, 1]')
    if any(float(s.abs().max()) != 0.0 for s in scores[:-1]):
        raise AssertionError('hi: eval_score nonzero before the last step')
    if info['n_placement_failures'].shape != (B,):
        raise AssertionError('hi: placement failures not reported per env')
    if not (launches['K1'] == 80 and launches['K4 slot'] == 80
            and launches['K4 frame'] == 1 and launches['K2'] == 0
            and launches['K3'] == 0):
        raise AssertionError(f'hi kernel launches {launches}')
    n = 64
    plain = render.render_views(first_envs(carry.state, n),
                                env.task.max_blocks, env.task.max_goals,
                                env.robot_first, views=('ego',),
                                fidelity='hi',
                                static_shapes=env.static_shapes)['ego']
    err = hi_diff(f'newest obs frame of {n} envs vs plain hi render',
                  obs[:n, ..., 9:12], plain, 'hi')
    print(f'[hi] obs {tuple(obs.shape)} uint8; done only at t=80; score '
          f'mean {float(score.mean()):.6f} in [0, 1]')
    return env, carry, launches['K1'], \
        launches['K4 frame'] + launches['K4 slot'], err, rate


def phase_gym():
    """The batch-1 Gym adapter at hi fidelity on the card: raw 384² frames
    through K4 at every step, render() and the score."""
    import numpy as np
    import torch
    from magical_tpu_torch.api import registry
    from magical_tpu_torch.core import physics_kernel, render, render_kernel
    env = registry.make(GYM_ENV_NAME, fidelity='hi', device=DEVICE)
    for c in (physics_kernel.control_step, render_kernel.render_views_hi):
        c.launches = 0
    env.seed(SEED)
    obs = env.reset()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    for t in range(1, env.max_episode_steps + 1):
        obs, rew, done, info = env.step(int(rng.integers(0, 18)))
        if done != (t == env.max_episode_steps):
            raise AssertionError(f'gym: done={done} at t={t}')
    dt = time.perf_counter() - t0
    frames = env.render()
    launches = {'K1': physics_kernel.control_step.launches,
                'K4': render_kernel.render_views_hi.launches}
    if not (isinstance(obs, dict) and set(obs) == {'allo', 'ego'} and all(
            v.shape == (384, 384, 3) and v.dtype == np.uint8
            for v in obs.values())):
        raise AssertionError('gym: obs is not two (384, 384, 3) uint8 frames')
    score = env.score_on_end_of_traj()
    if score not in (0.0, 1.0) or info['eval_score'] != score:
        raise AssertionError(f'gym: score {score}, eval_score '
                             f'{info["eval_score"]}')
    b = env._batched
    plain = render.render_views(env._carry.state, b.task.max_blocks,
                                b.task.max_goals, b.robot_first, res=384,
                                views=('allo', 'ego'), fidelity='hi',
                                static_shapes=b.static_shapes)
    err = 0
    for v in ('allo', 'ego'):
        got = torch.from_numpy(frames[v])
        err = max(err, hi_diff(f'render() {v} vs plain hi render 384²', got,
                               plain[v][0].cpu(), 'gym'))
    if launches['K1'] != 40 or launches['K4'] != 2 * 40 + 2 + 2:
        raise AssertionError(f'gym kernel launches {launches}')
    print(f'[gym] {GYM_ENV_NAME} fidelity=hi on {DEVICE}: 40 steps in '
          f'{dt:.3f} s (host clock); obs {{allo, ego}} (384, 384, 3) uint8; '
          f'done only at t=40; score {score}; launches {launches}')
    return err


def phase_hi_times(env, carry):
    """K4 and its plain version at the hi path's shapes."""
    from magical_tpu_torch.core import preproc, render, render_kernel
    state = carry.state.clone()
    B = state.batch
    args = (env.task.max_blocks, env.task.max_goals, env.robot_first)
    ss = env.static_shapes
    spec = env.preproc
    ring = {'ego': carry.frames['ego'].clone()}
    ms = cuda_ms(lambda: render_kernel.render_hi_into_slots(
        state, ring, 7, *args, spec, static_shapes=ss), 10)
    plain_ms = cuda_ms(lambda: preproc.push_frames_cf(
        spec, ring, render.render_views(
            state, *args, views=('ego',), fidelity='hi',
            static_shapes=ss), 7), 2)
    disp_ms = cuda_ms(lambda: render_kernel.kernel_display(
        state, *args, static_shapes=ss), 20)
    disp = render_kernel.kernel_display(state, *args, static_shapes=ss)
    slot = ring['ego'][7 % spec.depth('ego')]
    kern_ms = cuda_ms(lambda: render_kernel._launch(
        'render_hi_into_slot', disp, state, slot, 'ego', 96), 20)
    print(f'[times] K4 B={B} (hi path, ego 96², '
          f'{disp["nv"].shape[1]} prims): kernel {ms:.4f} ms (display list '
          f'build {disp_ms:.4f} ms; kernel alone, display list built: '
          f'{kern_ms:.4f} ms), plain {plain_ms:.4f} ms')
    return ms, plain_ms


def main():
    if not os.path.isdir(os.path.join(ROOT, 'magical_tpu_torch')):
        print('chip_smoke.py: run it from a checkout of the repository '
              '(magical_tpu_torch/ is missing)', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke.py: no CUDA device; the port runs its kernels '
              'only on a GPU', file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    k4_err = phase_kernels()
    env, carry, launches, rate = phase_main(smi)
    errs = phase_main_shapes(env, carry)
    times = phase_times(env, carry)
    del carry
    hi_env, hi_carry, hi_k1, hi_k4, hi_err, hi_rate = phase_hi(smi)
    gym_err = phase_gym()
    times['K4'] = phase_hi_times(hi_env, hi_carry)
    launches['K4'] = hi_k4
    errs['K4'] = max(k4_err, hi_err, gym_err)
    src = {'K1': ('cuda', 'magical_tpu_torch/csrc/physics_step.cu',
                  'magical_tpu/core/physics_pallas.py:1262'),
           'K2': ('cuda', 'magical_tpu_torch/csrc/render_lo.cu',
                  'magical_tpu/core/render_pallas.py:918'),
           'K3': ('cuda', 'magical_tpu_torch/csrc/render_lo.cu',
                  'magical_tpu/core/render_pallas.py:766'),
           'K4': ('cuda', 'magical_tpu_torch/csrc/render_hi.cu',
                  'magical_tpu/core/render_pallas.py:517')}
    names = {'K1': 'physics_control_step', 'K2': 'render_lo_into_slot',
             'K3': 'render_lo_frame', 'K4': 'render_hi'}
    kernels = [{'name': names[k], 'route': src[k][0], 'source': src[k][1],
                'replaces': src[k][2], 'launches': launches[k],
                'max_abs_err': errs[k], 'ms': times[k][0],
                'plain_ms': times[k][1]} for k in ('K1', 'K2', 'K3', 'K4')]
    print(f'[result] env-steps/s {rate:.1f} (lo main), {hi_rate:.1f} (hi, '
          f'K1 {hi_k1} and K4 {hi_k4} launches) on {smi}')
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
