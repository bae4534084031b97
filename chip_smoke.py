#!/usr/bin/env python3
"""Drive the PyTorch port (magical_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

  1. device  — requires a CUDA card; prints its name and power limit.
  2. build   — compiles each csrc/*.cu with its own nvcc for sm_90a into
               build/, all at once, and prints what ptxas reports for
               each kernel (registers, stack frame, spills).
  3. kernels — each kernel against its plain PyTorch version on the card,
               at B = 512, on states from seeded random-action rollouts of
               MoveToCorner-Demo, MoveToCorner-TestAll (every block shape,
               randomised dynamics), MoveToRegion-TestAll (active goals)
               and the Demo and TestAll variants of the six multi-block
               families (3 to 10 blocks, up to 138 display prims): the
               control step (1 and 5 steps; and twice on the same inputs,
               which must give the same bits), the lo render into a ring
               slot and into a fresh frame, the 2-D tiled lo render
               (tiles of 16² and 32², byte-equal to the plain lo render
               and to the fresh-frame kernel) and, on the Test states, the
               hi render into a ring slot and into a fresh frame (allo and
               ego views), every render building the display list on the
               card from the state; the hi and the tiled lo render at 384²
               on 4 MoveToRegion-TestAll and 4 ClusterColour-TestAll
               states; and the slice on the card against the slice on the
               CPU.
  4. main    — MoveToCorner-Demo-LoRes4E-v0 at 4096 envs: reset, then a
               full 80-step episode with seeded random actions, counting
               kernel launches and timing the steps with CUDA events;
               the card's busy share and the host-to-device copies a step
               from a profiler trace of 3 more steps (a copy fails the
               run); then, from the last state, each kernel against its
               plain version at the main path's shapes (one control step;
               allo and ego frames).
  5. hi      — MoveToCorner-TestAll-LoRes4E-v0 at hi fidelity, 1024 envs:
               reset and a full 80-step episode through the control step
               and the hi render, counted, timed and traced as `main` is
               (a host-to-device copy fails the run).
  6. gym     — MoveToRegion-TestAll-v0 through the registry's batch-1 Gym
               adapter at hi fidelity on the card: raw 384² {allo, ego}
               observations, a full 40-step episode (host clock), render()
               and the end-of-episode score.
  7. multi   — the six multi-block families at 4096 envs:
               ClusterColour-Demo-LoRes4E-v0 for a whole 240-step episode
               (checked as `main` is, and its last state by
               validate.state_finite; busy share and copies a step as in
               `main`); then <Family>-Demo-LoRes4E-v0 of
               every family, MoveToRegion's too, 5 warm-up and 20 timed
               steps each, and the mean env-steps/s over the 8 families;
               ClusterColour-TestAll-LoRes4E-v0 (138 display prims) for
               5 + 20 steps, with the card's busy share and copies a
               step from a profiler trace of 3 more; its frames through
               render_views_lo(tiles2d=(16, 16)), equal to the ring slot
               the step wrote; and ClusterColour-TestAll at hi fidelity,
               1024 envs, 5 + 5 steps.  Every path zeroes the launch
               counts just before it and reads them just after.
  8. times   — each kernel (time_kernel) on the last state of each path
               that runs it, beside its plain version and the kernel alone
               (its display program looked up; K1 its wrapper): the
               control step at every block count (4096 envs; mb 10 on Demo
               and on TestAll states), with its clock64() cycles per
               phase; the lo renders (ring slot, fresh frame) on the main
               path and at 138 prims, the fresh frame also over tiles of
               16², 32², 48² and 96² (one block a frame); the 2-D tiled lo
               render at 138 prims over both tilings of TILES (4096 envs);
               the hi render on the hi path and at 138 prims (1024 envs),
               also over output tiles of 8², 16², 32² and 96²; and the
               rest of the lo step, the observation assembly and the
               score, alone on the main path's and ClusterColour-TestAll's
               last states.
  9. episode — K1 over the whole episodes of the three legs of
               tests/fixtures/torch_episode_reference.npz (JAX's Demo
               resets, 64 distinct action sequences a leg: MoveToCorner
               at mb 1, 80 steps; MatchRegions at mb 8, 120;
               ClusterColour at mb 10, 240), read with numpy only, held
               to both parts of tests/fixtures/torch_episode_floor.json
               by one permutation test each (`hold`, T a run's largest
               log ratio to the median of all runs): the end part (the
               end poses' `dpos` median, 90th percentile and share
               within 0.05, against 16 XLA runs from resets moved 1 ulp;
               level 1/17; the mean |score difference| recorded beside
               it) and the step part (one K1 step into steps 1, 2, 4, 8,
               16, 32 and the last from the reference's state before it:
               per step and field of pos, angle, vel and omega the median
               over the envs of the largest |difference|, against 64 XLA
               steps from that state moved 1 ulp in those fields; level
               1/65), each printed with K1's T, the draws' largest T and
               each statistic's log ratio and rank; and, on env 0 and on
               the env where K1 ends furthest from the reference, the
               first step at which K1 leaves the plain version no further
               than 16 1-ulp draws of the plain version have by then.
 10. determinism — K1 32 times on the same inputs, every run's state bit
               for bit the first's: `[parity]`'s 64-env MoveToCorner-Demo
               case and a 4096-env ClusterColour-TestAll state (mb 10).
 11. parity  — the reference-parity resets: 64 scenes of each family's
               Demo and TestAll sampled by data/parity.py on the native
               MT19937 library (asserted), built on the card by
               state_from_spec, 25 K1 steps, K1, K2 and K3 against their
               plain versions, the worst K1 envs against 64 distinct 1-ulp
               nudges of themselves, the state envelope and the scores;
               the host's scenes/s on the native library and on numpy.
 12. eval    — eval/protocol.py with a seeded uniform-random policy over
               BatchedEnv(fidelity='hi').rollout, 1024 rollouts of every
               test env of MoveToCorner-Demo-LoRes4E-v0 and
               ClusterColour-Demo-LoRes4E-v0, with pandas blocked (the
               list of rows): the rows, the CI, _t_ppf against scipy, the
               same scores again, latexify_results; then a
               MoveToRegion-Demo-v0 demo recorded through the Gym adapter
               at hi (raw 384², K4), saved, loaded and preprocessed by the
               5 preprocessors, each newest frame byte-equal to
               native.resize_area_batch of its raw frame (that resize
               timed on the native library and on numpy).
 13. train   — the learner at full width on MoveToRegion (MagicalCNN and
               the Discriminator at their own widths, 96² x 12
               observations, bfloat16), K1, K2 and K3 under a network
               that acts on their frames, the launch counts zeroed before
               each part and printed after: the JAX-trained GAIL policy
               (gail_policy.msgpack, read by models/convert.py) over 1024
               greedy, 1024 stochastic and 1024 random rollouts of
               MoveToRegion-Demo-LoRes4E-v0 and -TestJitter-LoRes4E-v0
               beside GAIL_RESULT.json (the greedy mean at least 0.95 and
               its CI above random's; the stochastic mean's 95% Welch
               interval against JAX's holding 0), and its logits on 256
               of those observations against the same weights on the CPU
               (float32 and bfloat16); BC from 24 scripted-expert
               episodes, 300 AdamW steps of 128, then a greedy
               evaluation of 1024 envs (at least 0.8); and 3 GAIL
               iterations at 256 envs with the GAIL protocol's settings
               (both networks must move and stay finite), with the rates
               of collection, PPO and the discriminator and the card's
               busy share over the last iteration.
 14. dist    — the data-parallel path (parallel/, the trainers' `mesh`)
               on an NCCL process group of one rank (one card; NCCL
               takes one rank a card): rollout_episodes of
               MoveToCorner-Demo-LoRes4E-v0 at 4096 envs over the mesh,
               counted and timed as `main` is, its gathered scores bit for
               bit those of BatchedEnv.rollout from the same seed and
               random-action draws; env_throughput; two full-width BC
               steps over the mesh bit for bit the steps with no mesh
               (cudnn.deterministic); a GAIL iteration over the mesh at
               256 envs x 40 steps beside `train`'s.
 15. tools   — `python -m magical_tpu_torch --policy random --record` on
               MoveToRegion-Demo-v0 in a process of its own; its demo
               re-recorded at hi (K4, equal actions and score),
               rendered (ffmpeg or PPM frames); `--serve` in a process of
               its own on a free loopback port: a 384² /frame.png, /state
               advancing after POST /keys, the page.
 16. sweep   — tools/id_sweep.py over all 366 registered IDs from an
               empty ledger under build/: one whole episode of random
               actions at batch 2 each (done only at the end, scores in
               [0, 1] and 0 before it, finite positions); any failure
               fails the run.

Every kernel's line in the JSON table carries its bound: the larger of
its operations over 67 TFLOP/s (float32, outside the tensor cores) and
its bytes over 3.35 TB/s, the H100 SXM's published peaks at 700 W,
counted from this run's inputs by the models in `k1_work` and
`render_work`.

The last three lines of standard output are the card's name and power
limit, one JSON object with the kernel table and the result line
{"ok": true, "device": {...}}.
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
# The six multi-block task families and their block counts.
FAMILIES = {'FixColour': 3, 'MakeLine': 4, 'FindDupe': 7, 'MatchRegions': 8,
            'ClusterColour': 10, 'ClusterShape': 10}
MULTI_EPISODE = 'ClusterColour-Demo-LoRes4E-v0'
WIDE_NAME = 'ClusterColour-TestAll-LoRes4E-v0'    # 138 display prims
MULTI_WARM, MULTI_STEPS = 5, 20
TILES = ((16, 16), (32, 32))
# The tilings `[times]` runs K3 and K4 alone over (output pixels a block).
TILINGS = {'K3': ((16, 16), (32, 32), (48, 48), (96, 96)),
           'K4': ((8, 8), (16, 16), (32, 32), (96, 96))}
# `episode`: the reference's whole episodes (three legs of 64 distinct
# trajectories), the reference's own 1-ulp draws over them (the two parts
# of the hold K1 is held to), the steps over which K1 is bisected against
# the plain version, and the 1-ulp nudges the bisect compares it with;
# `determinism`: K1's runs on the same inputs.
EPISODE_FIXTURE = 'tests/fixtures/torch_episode_reference.npz'
EPISODE_FLOOR = 'tests/fixtures/torch_episode_floor.json'
# the step part's fields (tests/_torch_episode_fixture.STEP_FIELDS)
STEP_FIELDS = ('pos', 'angle', 'vel', 'omega')
EPISODE_TASKS = ('MoveToCorner', 'MatchRegions', 'ClusterColour')
EPISODE_BISECT, BISECT_ATOL, BISECT_NUDGES = 20, 1e-5, 16
DETERMINISM_RUNS = 32
# `parity`: scenes a family and variant, each run under PARITY_REPEAT
# action sequences (CHECK_BATCH envs, where phys_compare's 1-ulp tail is
# calibrated), K1 steps, the last steps, held against the plain version,
# and the 1-ulp nudges of each worst env (nudge_spread).
PARITY_SCENES, PARITY_REPEAT, PARITY_STEPS, PARITY_CHECK = 64, 8, 25, 1
PARITY_NUDGES = 64
# `eval`: the protocol's demo envs (each with all its test envs) and
# rollouts, and the env of the demo recorded through the Gym adapter.
EVAL_ENVS = ('MoveToCorner-Demo-LoRes4E-v0', 'ClusterColour-Demo-LoRes4E-v0')
EVAL_ROLLOUTS = 1024
DEMO_ENV_NAME = 'MoveToRegion-Demo-v0'
# `train`: the learner at full width (the networks' own widths, 96² x 12
# observations, bfloat16) on MoveToRegion: the JAX-trained GAIL policy
# (its result file beside it), BC from the scripted expert, GAIL
# iterations with the GAIL protocol's settings (GAIL_RESULT.json).
TRAIN_ENVS = ('MoveToRegion-Demo-LoRes4E-v0',
              'MoveToRegion-TestJitter-LoRes4E-v0')
JAX_POLICY = 'gail_policy.msgpack'
JAX_RESULT = 'GAIL_RESULT.json'
POLICY_ROLLOUTS = 1024
LOGIT_OBS = 256
BC_DEMOS, BC_STEPS, BC_BATCH, BC_LR = 24, 300, 128, 1e-3
GAIL_ENVS, GAIL_ITERS = 256, 3
GAIL_KW = dict(entropy_coef=0.02, disc_lr=5e-5, disc_freeze_acc=0.98,
               disc_obs_only=True)
GAIL_PPO_EPOCHS, GAIL_MINIBATCHES, GAIL_DISC_BATCH = 4, 4, 2048
# `tools`: the CLI, re-recording, rendering and the viewer on a raw ID
TOOLS_ENV = 'MoveToRegion-Demo-v0'
# Held: the JAX policy's greedy mean (JAX reads 1.0 on both envs) and BC's
# greedy Demo score (tests/test_training.py's bar); the network's logits
# on the card against the same weights on the CPU, relative to the
# largest logit: float32 (TF32 off) rounds apart in its sums only,
# bfloat16 by one bfloat16 ulp carried through the layers (the CPU tests'
# tolerance against flax).
POLICY_MIN_GREEDY = 0.95
BC_MIN_SCORE = 0.8
NET_F32_RTOL = 1e-4
NET_BF16_RTOL = 3e-2
# The H100 SXM's published peaks at 700 W (NVIDIA's data sheet).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

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
#  * The 2-D tiled lo render culls only prims whose alpha is exactly 0 on
#    the tile, and composites the rest as the fresh-frame kernel does:
#    byte-equal to it and to the plain lo render, no tolerance.
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
    import re
    from magical_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library(verbose=True)
    dt = time.perf_counter() - t0
    print(f'[build] nvcc {" ".join(_build.NVCC_FLAGS)}: {dt:.3f} s '
          f'(nvcc alone {_build.BUILD_SECONDS} s) -> {_build.BUILD_DIR}')
    # ptxas -v, one line per kernel: registers, stack frame, spills
    log = _build.BUILD_DIR / 'build.log'
    name = frame = src = None
    for line in (log.read_text().splitlines() if log.is_file() else ()):
        if ' -o ' in line:
            src = os.path.basename(line.split()[-1])
        m = re.fullmatch(r'(\d+\.\d+) s', line)
        if m:
            print(f'[build] nvcc {src}: {m.group(1)} s')
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m:
            frame = m.groups()
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            print(f'[build] ptxas {name}: {m.group(1)} registers, '
                  f'{frame[0] if frame else "?"} bytes stack frame, spill '
                  f'stores/loads {frame[1] if frame else "?"}/'
                  f'{frame[2] if frame else "?"} bytes')
            name = frame = None
    return dt


def bound(ops, nbytes):
    """(bound_ms, bound_by): the least time the card could take for
    `ops` float32 operations moving `nbytes` bytes."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def k1_work(state):
    """(operations, bytes) of one control step of `state` (K1), counted
    from the kernel's loops (csrc/physics_step.cuh) over what each env of
    this state runs, which skips inactive sub-shapes: per substep, every
    slot's vertices transformed (6 ops a vertex), the 4 walls against each
    active slot (60), each sub-shape pair of two active slots through SAT
    over both polygons' 8 faces and 8 vertices, incident face and
    clipping (720), and each live contact's prestep and warm-start match
    over the cache (60 + 2 MAXC); per solver iteration, each live contact
    (70) and the joint sweep (250 + 40 a block).  Bytes: every state
    tensor the kernel takes read once and written once."""
    import torch
    from magical_tpu_torch import constants as C
    from magical_tpu_torch.core import physics, physics_kernel
    mb = state.max_blocks
    nb, ns = 5 + mb, 5 + 6 * mb
    active = physics.slot_geometry(state)[3]                # (B, NS)
    sa, sb = (torch.as_tensor(x, device=active.device).long()
              for x in physics.pair_table(mb))
    n_slots = active.sum(1).double()
    n_pairs = (active[:, sa] & active[:, sb]).sum(1).double()
    maxc = state.con_id.shape[1]
    nc = (state.con_id >= 0).sum(1).double()              # (B,)
    per_sub = (ns * 8 * 6 + 4 * n_slots * 60 + n_pairs * 720 + nb * 12
               + nc * (60 + 2 * maxc)
               + C.PHYS_ITER * (nc * 70 + 250 + 40 * mb))
    ops = float((C.PHYS_STEPS * per_sub).sum())
    nbytes = 2 * sum(getattr(state, f).nelement()
                     * getattr(state, f).element_size()
                     for f, _, _ in physics_kernel._fields(mb))
    return ops, nbytes


def _prim_ops(disp, hard=False):
    """(B, P) operations per pixel (per subpixel if `hard`) of each
    active prim in the compositing loop (csrc/render_lo.cuh shade_levels):
    a polygon's SDF 5 a face, a circle's 7, coverage 4 (1 for a hard
    fill), an outline's band 6 more, a stippled one's perimeter phase 92
    more, and the blend 12."""
    from magical_tpu_torch.core import render
    nv = disp['nv'].double()
    kind = disp['kind'][None, :].expand_as(disp['nv'])
    sdf = _where64(nv == 1, 7.0, 5.0 * nv + 1.0)
    cover = _where64(kind == render.KIND_FILL, 1.0 if hard else 4.0, 6.0)
    stip = _where64(kind == render.KIND_LINE_STIPPLE, 92.0, 0.0)
    return (sdf + cover + stip + 12.0) * disp['active'].double()


def _where64(c, a, b):
    import torch
    return torch.where(c, torch.as_tensor(a, dtype=torch.float64,
                                          device=c.device),
                       torch.as_tensor(b, dtype=torch.float64,
                                       device=c.device))


def _samples_in(lo, hi, n):
    """How many of the sample centres s + 0.5, 0 <= s < n, lie in
    [lo, hi]."""
    first = (lo - 0.5).ceil().clamp(0, n)
    last = (hi - 0.5).floor().clamp(-1, n - 1)
    return (last - first + 1).clamp(min=0)


def render_work(disp, state, view, res, fidelity, inputs):
    """(operations, bytes, prims per sample) of one view's frames of
    `state` at `res`: the least work that gives them, which is the same
    for every kernel that renders them (K2, K3 and K5 at lo).  Each pixel
    (at hi fidelity each of its 16 subpixels) is composited over the
    active prims whose cull box holds it (prim_screen_bboxes on the
    sampled grid, outside which a prim's lo alpha and hi coverage are
    exactly 0), each prim of `disp` (kernel_display's list) at its
    _prim_ops; the camera and the quantise 22 ops a pixel or subpixel,
    the 4x4 mean 60 ops a pixel.  Bytes: what the kernel reads, `inputs`
    (the state's tensors and the display program), and the uint8 frames,
    once each."""
    import torch
    from magical_tpu_torch.core import render_kernel
    n = res * (4 if fidelity == 'hi' else 1)         # the sampled grid
    bb, bounded = render_kernel.prim_screen_bboxes(disp, state, view, n)
    bb = bb.double()
    area = (_samples_in(bb[..., 0], bb[..., 1], n)
            * _samples_in(bb[..., 2], bb[..., 3], n))
    area = torch.where(bounded, area, float(n * n)) \
        * disp['active'].double()                           # (B, P)
    per_prim = _prim_ops(disp, hard=fidelity == 'hi')
    ops = float((per_prim * area).sum()) + state.batch * n * n * 22 + (
        state.batch * res * res * 60 if fidelity == 'hi' else 0)
    nbytes = state.batch * res * res * 3 + sum(
        x.nelement() * x.element_size() for x in inputs)
    return ops, nbytes, float(area.sum()) / (state.batch * n * n)


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


def phys_compare(state0, actions, checks=(1, 5)):
    """Kernel vs plain vs plain-with-1-ulp-perturbed-positions, checked
    after each number of steps in `checks`; raises if the kernel is
    outside the tolerance.  Returns the largest 1-step position error."""
    import torch
    from magical_tpu_torch.core import physics, physics_kernel
    B = state0.batch
    sk = state0.clone()
    sc = state0.clone()
    sc.pos = torch.nextafter(sc.pos, torch.full_like(sc.pos, float('inf')))
    # the plain version steps both inputs in one batch of 2B envs: every
    # env is independent, and its time is mostly launch overhead
    both = cat_states(state0.clone(), sc)
    out = None
    for i in range(max(checks)):
        sk = physics_kernel.control_step(sk, actions[i])
        if i == 0:
            twin = physics_kernel.control_step(state0.clone(), actions[0])
            torch.cuda.synchronize()
            if not all(torch.equal(getattr(twin, f), getattr(sk, f))
                       for f, _, _ in physics_kernel._fields(
                           sk.max_blocks)):
                raise AssertionError(f'K1 mb={sk.max_blocks}: two runs on '
                                     f'the same inputs differ')
            print(f'[kernels] K1 mb={sk.max_blocks} B={B}: two runs on the '
                  f'same inputs give identical bits')
        both = physics.control_step(both, torch.cat([actions[i]] * 2))
        if i + 1 in checks:
            sp, sc = (slice_envs(both, k * B, (k + 1) * B) for k in (0, 1))
            err = phys_check(B, sk, sp, sc, i + 1)
            out = err if out is None else out
    return out


def phys_check(batch, sk, sp, sc, n_steps):
    """The tolerance of phys_compare after n_steps: kernel `sk`, plain
    `sp`, plain from 1-ulp-perturbed positions `sc`."""
    import torch
    torch.cuda.synchronize()
    report = {}
    for f, floor in PHYS_FLOOR.items():
        k, p, c = (getattr(s, f).double().reshape(batch, -1)
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
        line = (f'K1 mb={sk.max_blocks} B={batch} {n_steps}-step {f:9s} err '
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
    print(f'[kernels] K1 mb={sk.max_blocks} B={batch} {n_steps}-step con_id differs in '
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
    return slice_envs(state, 0, n)


def slice_envs(state, lo, hi):
    """Envs lo..hi-1 of a batched state."""
    import dataclasses
    return type(state)(**{f.name: getattr(state, f.name)[lo:hi].contiguous()
                          for f in dataclasses.fields(state)})


def cat_states(a, b):
    """Two batched states as one, a's envs first."""
    import dataclasses
    import torch
    return type(a)(**{f.name: torch.cat([getattr(a, f.name),
                                         getattr(b, f.name)])
                      for f in dataclasses.fields(a)})


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


def tiles_compare(env, state, res=96):
    """K5 through render_views_lo(tiles2d=...) against the plain lo render
    and against K3 (the fresh-frame kernel), allo and ego, for each tile
    shape of TILES; raises unless all three are byte-equal."""
    import torch
    from magical_tpu_torch.core import render, render_kernel
    args = (env.task.max_blocks, env.task.max_goals, env.robot_first)
    ss = env.static_shapes
    for view in ('allo', 'ego'):
        plain = render.render_views(state, *args, res=res, views=(view,),
                                    fidelity='lo', static_shapes=ss)[view]
        k3 = render_kernel.render_views_lo(state, *args, res=res,
                                           views=(view,),
                                           static_shapes=ss)[view]
        for tiles in TILES:
            k5 = render_kernel.render_views_lo(
                state, *args, res=res, views=(view,), static_shapes=ss,
                tiles2d=tiles)[view]
            torch.cuda.synchronize()
            d = int((k5.int() - plain.int()).abs().max())
            same = torch.equal(k5, plain) and torch.equal(k5, k3)
            print(f'[kernels] K5 {tiles[0]}x{tiles[1]} B={state.batch} '
                  f'{res}² {view}: max |diff| {d} levels from plain, '
                  f'byte-equal to plain and K3: {same}')
            if not same:
                raise AssertionError(f'K5 {tiles} {view} {res}² differs')


def phase_kernels():
    """Returns the largest errors: K1's 1-step position error per block
    count, K2/K3 levels, K4 levels (K5 is byte-equal or raises)."""
    errs = {'K1': {}, 'K2': 0, 'K3': 0, 'K4': 0, 'K5': 0}
    names = [ENV_NAME, *TEST_ENV_NAMES]
    for fam in FAMILIES:
        names += [f'{fam}-Demo-LoRes4E-v0', f'{fam}-TestAll-LoRes4E-v0']
    for name in names:
        env, state0, actions = rollout_states(CHECK_BATCH, 4, name)
        mb = env.task.max_blocks
        print(f'[kernels] states of {name}, B={CHECK_BATCH}, {mb} blocks')
        k1 = phys_compare(state0, actions)
        errs['K1'][mb] = max(errs['K1'].get(mb, 0.0), k1)
        for k, v in render_compare(env, state0).items():
            errs[k] = max(errs[k], v)
        tiles_compare(env, state0)
        if name != ENV_NAME:
            errs['K4'] = max(errs['K4'], hi_compare(env, state0, 96))
        if name in (TEST_ENV_NAMES[-1], WIDE_NAME):
            # raw observations: 384² frames, a 1536² subpixel grid
            few = first_envs(state0, RAW_CHECK_BATCH)
            errs['K4'] = max(errs['K4'], hi_compare(env, few, 384))
            tiles_compare(env, few, 384)
    slice_compare()
    return errs


def phase_main_shapes(env, carry):
    """Each kernel against its plain version at the main path's shapes,
    from the main path's last state; returns the max errors."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    act = torch.randint(0, 18, (1, carry.state.batch), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    return {'K1': phys_compare(carry.state.clone(), act, (1,)),
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
    carry, _, h2d = report_busy('main', ENV_NAME, env, carry)
    if h2d:
        raise AssertionError(f'main: {h2d} host-to-device copies a step; '
                             f'the lo step copies nothing from the host')
    return env, carry, launches, rate


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
    carry, _, h2d = report_busy('hi', HI_ENV_NAME, env, carry)
    if h2d:
        raise AssertionError(f'hi: {h2d} host-to-device copies a step; the '
                             f'hi step copies nothing from the host')
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


def counters():
    """The launch counter of every kernel wrapper, by kernel."""
    from magical_tpu_torch.core import physics_kernel, render_kernel as rk
    return {'K1': physics_kernel.control_step, 'K2': rk.render_into_slots,
            'K3': rk.render_views_lo, 'K4 frame': rk.render_views_hi,
            'K4 slot': rk.render_hi_into_slots, 'K5': rk.render_lo_tiles2d}


def zero_counts():
    import torch
    torch.cuda.synchronize()
    for c in counters().values():
        c.launches = 0


def read_counts():
    return {k: c.launches for k, c in counters().items()}


def drive(name, batch, n_steps=None, warm=MULTI_WARM, fidelity='lo'):
    """Env `name` on the card: reset `batch` envs, then n_steps (default:
    a whole episode) of seeded random actions, with the launch counts
    zeroed just before and read just after, and the steps after `warm`
    timed with CUDA events.  Returns a dict of what came out."""
    import torch
    from magical_tpu_torch.api.batched_env import BatchedEnv
    env = BatchedEnv(name, fidelity=fidelity, device=DEVICE)
    n_steps = n_steps or env.max_episode_steps
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    actions = torch.randint(0, 18, (n_steps, batch), generator=gen,
                            device=DEVICE, dtype=torch.int32)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    zero_counts()
    carry, obs = env.reset(SEED, batch)
    dones, scores = [], []
    for t in range(n_steps):
        if t == warm:
            start.record()
        carry, obs, rew, done, info = env.step(carry, actions[t])
        dones.append(done)
        scores.append(info['eval_score'])
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    ms = start.elapsed_time(end) / (n_steps - warm)
    rate = batch / (ms / 1e3)
    print(f'[multi] {name} fidelity={fidelity} B={batch}: {n_steps} steps, '
          f'{n_steps - warm} timed at {ms:.3f} ms/step = {rate:.1f} '
          f'env-steps/s; launches {launches}')
    want = {'K1': n_steps, 'K2': n_steps if fidelity == 'lo' else 0,
            'K4 slot': n_steps if fidelity == 'hi' else 0, 'K5': 0}
    if any(launches[k] != n for k, n in want.items()) or (
            launches['K3' if fidelity == 'lo' else 'K4 frame'] < 1):
        raise AssertionError(f'{name}: kernel launches {launches}')
    if tuple(obs.shape) != (batch, 96, 96, 12) or obs.dtype != torch.uint8:
        raise AssertionError(f'{name}: obs {tuple(obs.shape)} {obs.dtype}')
    return dict(env=env, carry=carry, obs=obs, done=torch.stack(dones),
                scores=torch.stack(scores), launches=launches, rate=rate,
                ms=ms)


def busy_share(fn):
    """fn() under torch.profiler: (its result, the card's busy share, the
    host-to-device copies); the share is kernel and copy time on the
    device over the host's wall time, None where the trace shows no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, h2d = 0.0, 0
    for e in prof.key_averages():
        dev_us = getattr(e, 'self_device_time_total',
                         getattr(e, 'self_cuda_time_total', 0.0))
        if str(getattr(e, 'device_type', '')).endswith('CUDA'):
            busy_us += dev_us
        if 'HtoD' in e.key:
            h2d += e.count
    return out, (busy_us / 1e6 / wall if busy_us > 0 else None), h2d


def device_busy(env, carry, n_steps=3):
    """The card's busy share over n_steps more steps of `env` from
    `carry` (busy_share), and the host-to-device copies per step; (None,
    None) where the trace shows no device time."""
    import torch
    act = torch.zeros(carry.state.batch, dtype=torch.int32, device=DEVICE)

    def steps():
        c = carry
        for _ in range(n_steps):
            c, *_ = env.step(c, act)
        return c

    carry, busy, h2d = busy_share(steps)
    if busy is None:
        return carry, None, None
    return carry, busy, h2d / n_steps


def report_busy(where, name, env, carry):
    """device_busy over 3 more steps, printed; returns (carry, busy share,
    host-to-device copies a step)."""
    carry, busy, h2d = device_busy(env, carry)
    print(f'[{where}] {name}: card busy '
          + ('not measured (no device time in the trace)' if busy is None
             else f'{busy:.1%} of 3 steps\' host wall time, '
             f'{h2d:.0f} host-to-device copies a step'))
    return carry, busy, h2d


def phase_multi(smi, main_rate):
    """The six multi-block families at 4096 envs (see the module
    docstring); returns what the kernel table needs."""
    import torch
    from magical_tpu_torch.core import render, render_kernel, validate
    out = {'K1 launches': {}, 'K1 carries': {}, 'rates': {}}

    # a whole ClusterColour-Demo episode
    r = drive(MULTI_EPISODE, MAIN_BATCH)
    env, carry = r['env'], r['carry']
    T = env.max_episode_steps
    done, scores = r['done'], r['scores']
    if bool(done[:-1].any()) or not bool(done[-1].all()):
        raise AssertionError(f'multi: done is not true exactly at t = {T}')
    score = scores[-1]
    if not (bool(torch.isfinite(score).all()) and float(score.min()) >= 0.0
            and float(score.max()) <= 1.0):
        raise AssertionError('multi: scores outside [0, 1]')
    if bool(scores[:-1].any()):
        raise AssertionError('multi: eval_score nonzero before the last step')
    newest = r['obs'][..., 9:12]
    plain = render.render_views(carry.state, *env._render_args(),
                                views=('ego',), fidelity='lo',
                                static_shapes=env.static_shapes)['ego']
    d = int((newest.int() - plain.int()).abs().max())
    if d > RENDER_MAX_LEVELS:
        raise AssertionError(f'multi: newest obs frame vs plain render: {d}')
    if not bool(validate.state_finite(carry.state)):
        raise AssertionError('multi: the last state left the envelope of '
                             'validate.state_finite')
    print(f'[multi] {MULTI_EPISODE} B={MAIN_BATCH}: done only at t={T}; '
          f'score mean {float(score.mean()):.6f} in [0, 1]; newest frame vs '
          f'plain render {d} levels; validate.state_finite holds on the last '
          f'state')
    out['K1 launches'][10] = r['launches']['K1']
    report_busy('multi', MULTI_EPISODE, env, carry)
    del r, env, carry

    # every family's Demo: bench.py's per-task rows
    for fam in list(FAMILIES) + ['MoveToRegion']:
        r = drive(f'{fam}-Demo-LoRes4E-v0', MAIN_BATCH,
                  MULTI_WARM + MULTI_STEPS)
        out['rates'][fam] = r['rate']
        mb = r['env'].task.max_blocks
        out['K1 launches'][mb] = out['K1 launches'].get(mb, 0) \
            + r['launches']['K1']
        if fam in FAMILIES:
            out['K1 carries'].setdefault(mb, (r['env'], r['carry']))
        del r
    rates = dict(out['rates'], MoveToCorner=main_rate)
    mean = sum(rates.values()) / len(rates)
    print('[multi] env-steps/s at 4096 envs, <Task>-Demo-LoRes4E-v0: '
          + ', '.join(f'{k} {v:.1f}' for k, v in rates.items()))
    print(f'[multi] mean env-steps/s over the families, n_tasks='
          f'{len(rates)}: {mean:.1f} on {smi}')
    out['mean'] = (mean, len(rates))

    # 138 display prims through K2, then K5 on the state it left
    r = drive(WIDE_NAME, MAIN_BATCH, MULTI_WARM + MULTI_STEPS)
    env, carry = r['env'], r['carry']
    P = render_kernel.display_program(*env._render_args(), env.static_shapes,
                                      DEVICE)[0].shape[0]
    out['K1 launches'][10] += r['launches']['K1']
    carry, _, _ = report_busy('multi', f'{WIDE_NAME} ({P} display prims)',
                              env, carry)
    zero_counts()
    frames = render_kernel.render_views_lo(
        carry.state, *env._render_args(), views=('allo', 'ego'),
        static_shapes=env.static_shapes, tiles2d=TILES[0])
    torch.cuda.synchronize()
    k5 = read_counts()
    slot = carry.frames['ego'][carry.t % env.preproc.depth('ego')]
    if k5['K5'] != 2 or not torch.equal(frames['ego'], slot):
        raise AssertionError(f'K5 path: launches {k5}, ego frame equal to '
                             f'the ring slot: '
                             f'{torch.equal(frames["ego"], slot)}')
    print(f'[multi] render_views_lo(tiles2d={TILES[0]}) on that state: '
          f'launches {k5}; ego frame byte-equal to the slot K2 wrote')
    out['K5 launches'] = k5['K5']
    out['p138 lo'] = (env, carry, r['launches'])
    del r

    # and at hi fidelity
    r = drive(WIDE_NAME, HI_BATCH, MULTI_WARM + 5, fidelity='hi')
    out['K1 launches'][10] += r['launches']['K1']
    out['p138 hi'] = (r['env'], r['carry'], r['launches'])
    return out


def time_kernel(k, env, carry, tiles=None):
    """Kernel `k` ('K1' to 'K5'; K5 on `tiles`) on the state of `carry`, a
    state of `env`, the ego view at 96² for a render: its wrapper and its
    plain version timed with CUDA events, the kernel alone (a render with
    its display program looked up, K1 as its wrapper) and, for K3 and K4,
    alone over each tiling of TILINGS, and the work of the function for
    its bound (k1_work, render_work).  Returns a dict of them."""
    import torch
    from magical_tpu_torch.core import (physics, physics_kernel, preproc,
                                        render, render_kernel as rk)
    state = carry.state.clone()
    if k == 'K1':
        act = torch.randint(0, 18, (state.batch,), device=DEVICE,
                            dtype=torch.int32, generator=torch.Generator(
                                device=DEVICE).manual_seed(SEED + 3))
        ms = cuda_ms(lambda: physics_kernel.control_step(state, act), 10)
        ops, nbytes = k1_work(state)
        # where a step's cycles go: clock64() per phase, summed over envs;
        # the narrowphase's items, and those its cull left to test in full
        clock = torch.zeros((state.batch, len(physics_kernel.PHASES)),
                            dtype=torch.int64, device=DEVICE)
        items = torch.zeros((state.batch, len(physics_kernel.ITEMS)),
                            dtype=torch.int64, device=DEVICE)
        physics_kernel.control_step(state.clone(), act, phase_clock=clock,
                                    item_count=items)
        per_env = clock.double().sum(0) / state.batch
        phases = dict(zip(physics_kernel.PHASES, per_env.tolist()))
        items = dict(zip(physics_kernel.ITEMS, items.sum(0).tolist()))
        return dict(ms=ms, alone_ms=ms, ops=ops, bytes=nbytes, phases=phases,
                    items=items,
                    plain_ms=cuda_ms(lambda: physics.control_step(state, act),
                                     1))
    args, ss, spec = env._render_args(), env.static_shapes, env.preproc
    fidelity = 'hi' if k == 'K4' else 'lo'
    ring = {'ego': carry.frames['ego'].clone()}
    disp = rk.kernel_display(state, *args, static_shapes=ss)

    def plain():
        return render.render_views(state, *args, views=('ego',),
                                   fidelity=fidelity, static_shapes=ss)
    if k in ('K2', 'K4'):
        wrapper = rk.render_into_slots if k == 'K2' else \
            rk.render_hi_into_slots
        ms = cuda_ms(lambda: wrapper(state, ring, 7, *args, spec,
                                     static_shapes=ss), 10)
        plain_ms = cuda_ms(lambda: preproc.push_frames_cf(spec, ring,
                                                          plain(), 7), 1)
        entry = 'render_lo_into_slot' if k == 'K2' else 'render_hi_into_slot'
        out = ring['ego'][7 % spec.depth('ego')]
    else:
        ms = cuda_ms(lambda: rk.render_views_lo(
            state, *args, views=('ego',), static_shapes=ss, tiles2d=tiles),
            10)
        plain_ms = cuda_ms(plain, 1)
        entry = 'render_lo_frame' if k == 'K3' else 'render_lo_tiles2d'
        out = torch.empty((state.batch, 96, 96, 3), dtype=torch.uint8,
                          device=DEVICE)
    # the kernel alone: the display program looked up, the list built in
    # the kernel; and K3 and K4 over each tiling, one block a whole frame
    # (96 x 96) included
    prog = rk.display_program(*args, ss, state.device)
    alone_ms = cuda_ms(lambda: rk._launch_scene(entry, prog, state, out,
                                                'ego', 96, tiles), 20)
    tiles_ms = {tile: cuda_ms(lambda: rk._launch_scene(
        entry, prog, state, out, 'ego', 96, tile), 20)
        for tile in TILINGS.get(k, ())}
    inputs = [getattr(state, f) for f, _ in rk._SCENE_FIELDS] + list(prog)
    ops, nbytes, per_sample = render_work(disp, state, 'ego', 96, fidelity,
                                          inputs)
    return dict(ms=ms, alone_ms=alone_ms, plain_ms=plain_ms, ops=ops,
                bytes=nbytes, per_sample=per_sample,
                prims=disp['nv'].shape[1], tiles_ms=tiles_ms)


def phase_times(cases):
    """time_kernel for each (label, kernel, env, carry, tiles) of `cases`;
    returns {label: its dict}."""
    times = {}
    for label, k, env, carry, tiles in cases:
        t = times[label] = time_kernel(k, env, carry, tiles)
        bound_ms, bound_by = bound(t['ops'], t['bytes'])
        what = (f'{env.env_name}, B={carry.state.batch}' + (
            '' if k == 'K1' else f', ego 96², {t["prims"]} prims, '
            f'{t["per_sample"]:.3f} prims composited a '
            f'{"subpixel" if k == "K4" else "pixel"}'))
        print(f'[times] {label} ({what}): kernel {t["ms"]:.4f} ms'
              + ('' if k == 'K1' else f' (alone {t["alone_ms"]:.4f} ms)')
              + f', plain {t["plain_ms"]:.4f} ms, bound {bound_ms:.5f} ms '
              f'({bound_by})')
        if t.get('phases'):
            cyc = t['phases']
            total = sum(cyc.values())
            print(f'[times] {label} cycles an env a step (clock64, lane 0): '
                  f'{total / 1e6:.3f} M; ' + ', '.join(
                      f'{p} {v / total:.1%}' for p, v in cyc.items()))
            n = t['items']
            print(f'[times] {label} narrowphase items an env a step: '
                  f'{n["candidates"] / carry.state.batch:.1f}, '
                  f'{n["tested"] / max(n["candidates"], 1):.2%} tested in '
                  f'full')
        if t.get('tiles_ms'):
            print(f'[times] {label} by tiling (kernel alone): ' + ', '.join(
                f'{r}x{c} {v:.4f} ms' for (r, c), v in t['tiles_ms'].items()))
    return times


def step_rest(env, carry):
    """The step's work besides K1 and the render, each part alone on the
    state of `carry`, timed with CUDA events and printed: the observation
    assembly (preproc.observation_cf) and the score."""
    from magical_tpu_torch.core import preproc
    spec = env.preproc
    obs_ms = cuda_ms(lambda: preproc.observation_cf(spec, carry.frames,
                                                    carry.t, spec.res), 20)
    score_ms = cuda_ms(lambda: env.task.score_fn(carry.state), 20)
    print(f'[times] rest of the step ({env.env_name}, '
          f'B={carry.state.batch}): observation {obs_ms:.4f} ms, score '
          f'{score_ms:.4f} ms')


def fixture_state(data, task, which):
    """The fixture's `which` state of `task` as {field: numpy}."""
    import dataclasses
    from magical_tpu_torch.core.state import EnvState
    return {f.name: data[f'{task}/{which}/{f.name}']
            for f in dataclasses.fields(EnvState)}


def dpos_stats(pos, ref_pos):
    """scripts/chaos_floor.py:83-95 (and tests/_torch_episode_fixture.py):
    the per-body position distance of two end states, its median, 90th
    percentile and share within 0.05."""
    import numpy as np
    dpos = np.linalg.norm(np.asarray(pos, np.float32)
                          - np.asarray(ref_pos, np.float32), axis=-1)
    return dict(dpos_median=float(np.median(dpos)),
                dpos_p90=float(np.percentile(dpos, 90)),
                frac_within_0p05=float((dpos < 0.05).mean()))


def nudge_up(k, shape):
    """tests/_torch_episode_fixture.py's 1-ulp draws: which position
    coordinates draw k moves up (all for k = 0; the rest go down)."""
    import numpy as np
    if k == 0:
        return np.ones(shape, bool)
    return np.random.RandomState(k).randint(0, 2, shape).astype(bool)


def episode_bisect(data, task, env, k1_pos):
    """Env `env` of K1 (`k1_pos`, its positions after each of the first
    EPISODE_BISECT steps) against the plain version on the card from the
    same reset under the same actions, and the plain version from that
    reset under BISECT_NUDGES 1-ulp draws of its positions: the first step
    at which K1 leaves the plain version by more than BISECT_ATOL, and how
    far the draws have left it by then.  Returns whether K1 is no further
    than the furthest draw there (True if it stays within BISECT_ATOL)."""
    import numpy as np
    import torch
    from magical_tpu_torch.core import physics
    from magical_tpu_torch.core.convert import state_from_numpy
    reset = fixture_state(data, task, 'reset')
    rows = {k: np.repeat(v[env:env + 1], BISECT_NUDGES + 1, 0)
            for k, v in reset.items()}
    pos = rows['pos'][1:]
    for k in range(BISECT_NUDGES):
        pos[k] = np.where(nudge_up(k, pos[k].shape),
                          np.nextafter(pos[k], np.float32(np.inf)),
                          np.nextafter(pos[k], np.float32(-np.inf)))
    st = state_from_numpy(rows, DEVICE)
    acts = data[f'{task}/actions'][:, env]
    for t, p in enumerate(k1_pos, 1):
        st = physics.control_step(st, torch.full(
            (BISECT_NUDGES + 1,), int(acts[t - 1]), dtype=torch.int32,
            device=DEVICE))
        plain = st.pos.cpu().numpy()
        k_off = float(np.linalg.norm(p - plain[0], axis=-1).max())
        if k_off > BISECT_ATOL:
            off = np.linalg.norm(plain[1:] - plain[:1], axis=-1).max(-1)
            q = np.percentile(off, [0, 50, 100])
            ok = k_off <= q[2]
            print(f'[episode] {task} env {env} bisect: K1 first leaves the '
                  f'plain version by more than {BISECT_ATOL:.0e} at step {t} '
                  f'({k_off:.3e}); the plain version\'s {BISECT_NUDGES} 1-ulp '
                  f'draws have left it by min/median/max {q[0]:.3e}/'
                  f'{q[1]:.3e}/{q[2]:.3e} there' + ('' if ok else
                                                   ': K1 is further'))
            return ok
    print(f'[episode] {task} env {env} bisect: K1 within {BISECT_ATOL:.0e} '
          f'of the plain version for {len(k1_pos)} steps')
    return True


def worse_first(stat, x):
    """tests/_torch_episode_fixture.worse_first: `x` oriented so that
    higher is worse (the share within 0.05 as the share beyond it), NaN
    the worst."""
    import numpy as np
    x = np.asarray(x, np.float64)
    if stat.split('/')[-1].startswith('frac'):
        x = 1 - x
    return np.where(np.isnan(x), np.inf, x)


def mid_ranks(x):
    """Mid-ranks (1 = least) along the last axis, ties averaged."""
    import numpy as np
    x = np.asarray(x)
    less = (x[..., None, :] < x[..., :, None]).sum(-1)
    same = (x[..., None, :] == x[..., :, None]).sum(-1)
    return less + (same + 1) / 2


def log_ratios(runs):
    """log(value / the median over the runs) of (S, R) oriented
    statistics: 0 where a value equals the median, +inf where the median
    is 0 and the value is not."""
    import numpy as np
    med = np.median(runs, -1, keepdims=True)
    with np.errstate(divide='ignore', invalid='ignore'):
        return np.where(runs == med, 0.0, np.log(runs / med))


def hold(candidate, draws):
    """tests/_torch_episode_fixture.hold, the rule of the episode hold (a
    tier-1 test holds the two copies to the same answer): `candidate`
    {statistic: value} against `draws` {statistic: [one a draw]}, the
    statistics of every leg of a part.  Each of the D + 1 runs gets, in
    every statistic, the log of its value over the median of the D + 1
    values, the worse the higher; T is a run's largest; the candidate
    fails if its T is above every draw's (ties pass), which a candidate
    exchangeable with the draws does with probability at most 1/(D + 1).
    Returns {passed, T, T_draws_max, level, ratios, ranks}."""
    import numpy as np
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


def end_stats(st, task, data):
    """The end part's statistics of the end state `st` of `task`'s leg
    against the reference's end poses and scores, and its scores."""
    import numpy as np
    from magical_tpu_torch.tasks import ALL_TASKS
    score = ALL_TASKS[task].score_fn(st).cpu().numpy()
    return dict(dpos_stats(st.pos.cpu().numpy(), data[f'{task}/end/pos']),
                dscore_mean=float(np.mean(np.abs(
                    score.astype(np.float64) - data[f'{task}/score'])))), score


def step_stats(data, task, horizons):
    """tests/_torch_episode_fixture.step_stats of K1: one K1 step into
    each of `horizons` from the reference's state before it (`reset`
    before step 1, `before<h>` else), its pos, angle, vel and omega
    against the reference's after it (`end` after the last step,
    `after<h>` else): per horizon and field the median over the envs of
    the largest |difference|."""
    import numpy as np
    import torch
    from magical_tpu_torch.core import physics_kernel
    from magical_tpu_torch.core.convert import state_from_numpy
    out = {}
    for h in horizons:
        before = fixture_state(data, task, 'reset' if h == 1
                               else f'before{h}')
        after = 'end' if h == horizons[-1] else f'after{h}'
        nxt = physics_kernel.control_step(
            state_from_numpy(before, DEVICE),
            torch.as_tensor(data[f'{task}/actions'][h - 1], device=DEVICE))
        for f in STEP_FIELDS:
            d = np.abs(getattr(nxt, f).cpu().numpy().astype(np.float64)
                       - data[f'{task}/{after}/{f}'])
            out[f'{f}_h{h}'] = float(np.median(d.reshape(len(d), -1).max(1)))
    return out


def print_hold(part, fl, stats):
    """Hold `stats` ({'<task>/<stat>': K1's value}) to part `part` of the
    floor `fl` and print its T, the draws' largest T, the level and each
    statistic's log ratio and rank among the draws + 1 runs (a statistic
    the part only records, beside the draws).  Returns hold's verdict."""
    import numpy as np
    recorded = fl[part].get('recorded', [])
    every = {f'{t}/{s}': v for t, leg in fl[part]['legs'].items()
             for s, v in leg['draws'].items()}
    draws = {k: v for k, v in every.items()
             if k.split('/')[1] not in recorded}
    v = hold(stats, draws)
    n = fl[part]['n_draws']
    print(f'[episode] {part} part: K1 T {v["T"]:.4f}, the draws\' largest '
          f'T {v["T_draws_max"]:.4f} ({"passed" if v["passed"] else "FAILED"}'
          f'; level 1/{n + 1} = {v["level"]:.4f}, {n} draws; null: '
          f'{fl[part]["null"]})')
    for s in stats:
        held = (f'log ratio {v["ratios"][s]:.4f}, rank {v["ranks"][s]:.1f} '
                f'of {n + 1} (worst {n + 1})' if s in draws else 'recorded')
        print(f'[episode] {part} {s}: K1 {stats[s]:.6e}, {held}; draws '
              f'min/median/max {np.min(every[s]):.6e}/'
              f'{np.median(every[s]):.6e}/{np.max(every[s]):.6e}')
    return v


def phase_episode():
    """K1 over the whole episode of each leg of EPISODE_FIXTURE, from its
    JAX resets, each env under its own actions, held to both parts of
    EPISODE_FLOOR by `hold`: the end part (the end poses' `dpos` median,
    p90 and share within 0.05, against 16 XLA draws from resets moved 1
    ulp; the mean |score difference| recorded) and the step part (one K1
    step into each of its horizons from the reference's state, against 64
    XLA steps from that state moved 1 ulp: `step_stats`), each part over
    all three legs; then the bisect of
    episode_bisect on env 0 and on the env where K1 ends furthest from the
    reference.  A failed part or a fault the bisect pins on K1 fails the
    phase, after every leg has run.  Returns K1's launches per task and
    each part's verdict."""
    import numpy as np
    import torch
    from magical_tpu_torch.core import physics_kernel
    from magical_tpu_torch.core.convert import state_from_numpy
    from magical_tpu_torch.tasks import ALL_TASKS
    with np.load(os.path.join(ROOT, EPISODE_FIXTURE)) as f:
        data = {k: f[k] for k in f.files}
    with open(os.path.join(ROOT, EPISODE_FLOOR)) as f:
        floor = json.load(f)
    launches, pinned = {}, []
    stats = {'end': {}, 'step': {}}
    for task in EPISODE_TASKS:
        n_steps = ALL_TASKS[task].ep_len
        acts = torch.as_tensor(data[f'{task}/actions'], device=DEVICE)
        st = state_from_numpy(fixture_state(data, task, 'reset'), DEVICE)
        B = st.batch
        if tuple(acts.shape) != (n_steps, B):
            raise AssertionError(f'episode {task}: actions {acts.shape}')
        trace = {int(s): i for i, s in enumerate(data[f'{task}/trace_steps'])}
        zero_counts()
        t0 = time.perf_counter()
        seen, k1_pos = [], []
        for t in range(n_steps):
            st = physics_kernel.control_step(st, acts[t])
            if t + 1 in trace:
                seen.append((t + 1, st.pos.cpu().numpy()))
            if t < EPISODE_BISECT:
                k1_pos.append(st.pos.cpu().numpy())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[task] = read_counts()['K1']
        if launches[task] != n_steps:
            raise AssertionError(f'episode {task}: K1 launches '
                                 f'{launches[task]} != {n_steps}')
        # where the divergence grows: the largest and the median body
        # distance at each traced step
        print(f'[episode] {task}: K1 |pos - reference| max/median at steps '
              + ', '.join(
                  f'{s} {d.max():.2e}/{np.median(d):.2e}' for s, d in (
                      (s, np.linalg.norm(p - data[f'{task}/trace_pos'][
                          trace[s]], axis=-1)) for s, p in seen)))
        end, score = end_stats(st, task, data)
        step = step_stats(data, task,
                          floor['step']['legs'][task]['horizons'])
        stats['end'].update({f'{task}/{s}': v for s, v in end.items()})
        stats['step'].update({f'{task}/{s}': v for s, v in step.items()})
        want = data[f'{task}/score']
        print(f'[episode] {task} B={B}, mb {st.max_blocks}, {n_steps} K1 '
              f'steps in {dt:.3f} s (host clock); end scores above 0: K1 '
              f'{int((score > 0).sum())}, reference {int((want > 0).sum())} '
              f'of {B} (mean {float(score.mean()):.6f}, reference '
              f'{float(want.mean()):.6f})')
        worst = int(np.linalg.norm(st.pos.cpu().numpy()
                                   - data[f'{task}/end/pos'],
                                   axis=-1).max(-1).argmax())
        for env in sorted({0, worst}):
            if not episode_bisect(data, task, env,
                                  [p[env] for p in k1_pos]):
                pinned.append((task, env))
    print(f'[episode] the rule: {floor["rule"]}')
    verdicts = {part: print_hold(part, floor, stats[part])
                for part in ('end', 'step')}
    failed = [p for p, v in verdicts.items() if not v['passed']]
    said = (f'failed the {" and ".join(failed)} part' if failed
            else 'passed both parts')
    print(f'[episode] K1 {said} over {", ".join(EPISODE_TASKS)}; the '
          'bisect pins ' + (f'K1 on {pinned}' if pinned else 'nothing on K1'))
    if failed or pinned:
        raise AssertionError(f'episode: K1 failed the {failed} part of the '
                             f'reference\'s hold; the bisect pins K1 on '
                             f'{pinned}')
    return launches, verdicts


def parity_case():
    """`[parity]`'s MoveToCorner-Demo case at PARITY_SCENES envs: the
    parity scenes of seeds 0.. built by state_from_spec, PARITY_STEPS - 1
    K1 steps under the actions a batch of PARITY_SCENES envs draws from the
    phase's generator (seed SEED + 7).  Returns that state and the last
    step's actions."""
    import torch
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.core import physics_kernel
    from magical_tpu_torch.data import parity
    env = BatchedEnv('MoveToCorner-Demo-LoRes4E-v0', device=DEVICE)
    specs, _ = parity_specs('MoveToCorner', env.flags)
    st = parity.state_from_spec(specs, env.task.max_blocks,
                                env.task.max_goals, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    acts = torch.randint(0, 18, (PARITY_STEPS, st.batch), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    for t in range(PARITY_STEPS - 1):
        st = physics_kernel.control_step(st, acts[t])
    return st, acts[-1]


def phase_determinism(wide_state):
    """K1 DETERMINISM_RUNS times on the same inputs, each run's whole
    state bit for bit the first's: on parity_case's 64 MoveToCorner envs
    and on `wide_state` (ClusterColour-TestAll, mb 10, MAIN_BATCH envs)
    under seeded random actions."""
    import dataclasses
    import torch
    from magical_tpu_torch.core import physics_kernel
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    wide_act = torch.randint(0, 18, (wide_state.batch,), generator=gen,
                             device=DEVICE, dtype=torch.int32)
    for label, (st, act) in (
            ('MoveToCorner-Demo parity case', parity_case()),
            ('ClusterColour-TestAll', (wide_state, wide_act))):
        runs = [physics_kernel.control_step(st.clone(), act)
                for _ in range(DETERMINISM_RUNS)]
        same = sum(all(torch.equal(getattr(r, f.name),
                                   getattr(runs[0], f.name))
                       for f in dataclasses.fields(r)) for r in runs)
        print(f'[determinism] {label}, B={st.batch}, mb {st.max_blocks}: K1 '
              f'{same} of {DETERMINISM_RUNS} runs on the same inputs bit for '
              f'bit the first')
        if same != DETERMINISM_RUNS:
            raise AssertionError(f'determinism {label}: K1 gave other bits '
                                 f'in {DETERMINISM_RUNS - same} runs')


def repeat_env(state, env, n):
    """Env `env` of a batched state, n times."""
    import dataclasses
    import torch
    idx = torch.full((n,), env, dtype=torch.long, device=state.pos.device)
    return type(state)(**{f.name: getattr(state, f.name)[idx].contiguous()
                          for f in dataclasses.fields(state)})


def nudge_spread(state, env, action):
    """One step from env `env` of `state`: K1's largest position error
    against the plain version, and how far PARITY_NUDGES distinct 1-ulp
    nudges of that env (each position coordinate up or down by a seeded
    sign) move the plain version, each the largest coordinate."""
    import torch
    from magical_tpu_torch.core import physics, physics_kernel
    n = PARITY_NUDGES
    rows = repeat_env(state, env, n + 1)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    up = torch.rand(rows.pos[1:].shape, generator=gen, device=DEVICE) < 0.5
    rows.pos[1:] = torch.where(
        up, torch.nextafter(rows.pos[1:], torch.full_like(rows.pos[1:], 1e30)),
        torch.nextafter(rows.pos[1:], torch.full_like(rows.pos[1:], -1e30)))
    act = action[env:env + 1].expand(n + 1).contiguous()
    k = physics_kernel.control_step(repeat_env(state, env, 1), act[:1])
    p = physics.control_step(rows, act)
    err = float((k.pos[0] - p.pos[0]).abs().max())
    spread = (p.pos[1:] - p.pos[:1]).abs().flatten(1).amax(1)
    return err, spread


def parity_specs(task, flags):
    """PARITY_SCENES scenes of `task` (seeds 0..) and the host's seconds."""
    from magical_tpu_torch.data import parity
    t0 = time.perf_counter()
    specs = [parity.sample_scene(task, s, flags)
             for s in range(PARITY_SCENES)]
    return specs, time.perf_counter() - t0


def phase_parity():
    """The reference-parity resets on the card: for each family and
    {Demo, TestAll}, PARITY_SCENES scenes of seeds 0.. sampled on the
    native MT19937 backend (asserted) and again on the numpy fallback (the
    same scenes, both timed), built with state_from_spec on the card, each
    PARITY_REPEAT times, PARITY_STEPS seeded random K1 steps (counted; the
    first PARITY_SCENES envs take the actions a batch of PARITY_SCENES
    envs draws), K1 against its plain version over the last PARITY_CHECK
    steps, and the envs where K1 is furthest from it (among the first
    PARITY_SCENES and among all), where beyond PHYS_FLOOR, against their
    own 1-ulp nudges (nudge_spread), K2/K3 against the plain render and
    validate.state_finite on the last state, scores in [0, 1].  Returns
    the host's scenes/s and K1's launches."""
    import dataclasses
    import torch
    from magical_tpu_torch import native
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.core import physics, physics_kernel, validate
    from magical_tpu_torch.data import parity
    from magical_tpu_torch.tasks import ALL_TASKS
    if not native.available():
        raise AssertionError(f'native library unavailable: '
                             f'{native.build_error}')
    print(f'[parity] MT19937 backend: {native.backend()} '
          f'({native.library_path().name})')

    def key(spec):
        return repr(dataclasses.replace(spec, phys=None)), \
            spec.phys.tobytes()

    n_scenes, host_s, numpy_s, k1 = 0, 0.0, 0.0, 0
    for task in parity.SAMPLERS:
        for variant in ('Demo', 'TestAll'):
            env = BatchedEnv(f'{task}-{variant}-LoRes4E-v0', device=DEVICE)
            specs, dt = parity_specs(task, env.flags)
            host_s += dt
            n_scenes += len(specs)
            # the same scenes on the numpy fallback
            load, native._load = native._load, lambda: None
            try:
                np_specs, dt = parity_specs(task, env.flags)
            finally:
                native._load = load
            numpy_s += dt
            if [key(s) for s in np_specs] != [key(s) for s in specs]:
                raise AssertionError(f'parity {task}-{variant}: the native '
                                     f'and numpy streams give other scenes')
            st = parity.state_from_spec(specs * PARITY_REPEAT,
                                        env.task.max_blocks,
                                        env.task.max_goals, device=DEVICE)
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
            acts = torch.cat([torch.randint(
                0, 18, (PARITY_STEPS, n), generator=gen, device=DEVICE,
                dtype=torch.int32) for n in (PARITY_SCENES,
                                             st.batch - PARITY_SCENES)], 1)
            zero_counts()
            for t in range(PARITY_STEPS):
                if t == PARITY_STEPS - PARITY_CHECK:
                    before = st.clone()
                st = physics_kernel.control_step(st, acts[t])
            torch.cuda.synchronize()
            n = read_counts()['K1']
            if n != PARITY_STEPS:
                raise AssertionError(f'parity {task}-{variant}: K1 launches '
                                     f'{n}')
            k1 += n
            last = acts[PARITY_STEPS - PARITY_CHECK:]
            phys_compare(before, last, (PARITY_CHECK,))
            err = (physics_kernel.control_step(before.clone(), last[0]).pos
                   - physics.control_step(before.clone(), last[0]).pos
                   ).abs().flatten(1).amax(1)
            # the envs furthest from it; one beyond PHYS_FLOOR must lie
            # within CHAOS_FACTOR x its own 1-ulp nudges (below the floor
            # that cannot fail)
            for n_envs in (PARITY_SCENES, st.batch):
                i = int(err[:n_envs].argmax())
                line = (f'[parity] {task}-{variant}: K1\'s worst env of the '
                        f'first {n_envs}, env {i}: 1-step pos err '
                        f'{float(err[i]):.3e}')
                if float(err[i]) <= PHYS_FLOOR['pos']:
                    print(line + f' <= the floor {PHYS_FLOOR["pos"]:.0e}')
                    continue
                e, spread = nudge_spread(before, i, last[0])
                tol = max(PHYS_FLOOR['pos'],
                          CHAOS_FACTOR * float(spread.max()))
                q = torch.quantile(spread.double(), torch.tensor(
                    [0.0, 0.5, 1.0], dtype=torch.float64,
                    device=spread.device)).tolist()
                print(line + f' ({e:.3e} alone); its {PARITY_NUDGES} 1-ulp '
                      f'nudges move the plain version by min/median/max '
                      f'{q[0]:.3e}/{q[1]:.3e}/{q[2]:.3e}; held <= {tol:.3e}')
                if e > tol:
                    raise AssertionError(
                        f'parity {task}-{variant} env {i}: K1 is further '
                        f'from the plain version than its 1-ulp nudges')
            render_compare(env, st)
            score = env.task.score_fn(st)
            if not (bool(validate.state_finite(st))
                    and bool(torch.isfinite(score).all())
                    and float(score.min()) >= 0 and float(score.max()) <= 1):
                raise AssertionError(f'parity {task}-{variant}: state or '
                                     f'scores out of bounds')
            print(f'[parity] {task}-{variant}: {len(specs)} scenes x '
                  f'{PARITY_REPEAT} = {st.batch} envs, '
                  f'{ALL_TASKS[task].max_blocks} block slots, '
                  f'{PARITY_STEPS} K1 steps; state finite, score mean '
                  f'{float(score.mean()):.6f} in [0, 1]')
    rate = n_scenes / host_s
    print(f'[parity] {n_scenes} scenes sampled on the host in {host_s:.3f} '
          f's = {rate:.1f} scenes/s on the native library; the same scenes '
          f'on numpy in {numpy_s:.3f} s = {n_scenes / numpy_s:.1f} '
          f'scenes/s; K1 launches {k1}')
    return rate, k1


def phase_eval(smi):
    """The evaluation protocol on the card with pandas blocked (so it
    returns the list of rows), then one demo recorded through the Gym
    adapter at hi fidelity, saved, loaded and preprocessed.  Returns K1's
    and K4's launches."""
    import tempfile
    import numpy as np
    import scipy.stats
    import torch
    from magical_tpu_torch import native
    from magical_tpu_torch.api import registry
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.core.preproc import PREPROCESSORS
    from magical_tpu_torch.data import trajectories as T
    from magical_tpu_torch.eval import protocol as E

    class RandomPolicyEval(E.EvaluationProtocol):
        """A seeded uniform-random policy, EVAL_ROLLOUTS envs at hi
        fidelity on the card."""
        run_id = 'uniform-random'
        scores = {}

        def obtain_scores(self, env_name):
            env = BatchedEnv(env_name, fidelity='hi', device=DEVICE)
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
            carry, obs = env.reset(SEED, self.n_rollouts)
            *_, scores = env.rollout(
                carry, obs, lambda o, g: torch.randint(
                    0, 18, (self.n_rollouts,), generator=g, device=DEVICE,
                    dtype=torch.int32), gen)
            self.scores[env_name] = scores[-1].cpu().tolist()
            return self.scores[env_name]

    launches = {'K1': 0, 'K4': 0}
    df = EVAL_ROLLOUTS - 1
    ppf = E._t_ppf(0.975, df)
    if abs(ppf - scipy.stats.t.ppf(0.975, df)) > 1e-8:
        raise AssertionError(f'_t_ppf(0.975, {df}) = {ppf!r}, scipy '
                             f'{scipy.stats.t.ppf(0.975, df)!r}')
    registry.register_envs()
    for demo in EVAL_ENVS:
        ev = RandomPolicyEval(demo_env_name=demo, n_rollouts=EVAL_ROLLOUTS)
        zero_counts()
        t0 = time.perf_counter()
        # the protocol as on a machine without pandas, installed or not
        pandas = sys.modules.get('pandas')
        sys.modules['pandas'] = None
        try:
            rows = ev.do_eval()
        finally:
            if pandas is None:
                del sys.modules['pandas']
            else:
                sys.modules['pandas'] = pandas
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = read_counts()
        if not isinstance(rows, list):
            raise AssertionError(f'eval {demo}: without pandas do_eval gave '
                                 f'a {type(rows).__name__}')
        want = [demo, *registry.DEMO_ENVS_TO_TEST_ENVS_MAP[demo]]
        k4 = n['K4 frame'] + n['K4 slot']
        print(f'[eval] {demo}: {len(rows)} envs x {EVAL_ROLLOUTS} hi '
              f'rollouts in {dt:.3f} s (host clock) on {smi}; a list of '
              f'rows (pandas blocked); launches {n}')
        for r in rows:
            print(f'[eval]   {r["test_env"]}: mean {r["mean_score"]:.6f} '
                  f'CI95 [{r["ci95_lower"]:.6f}, {r["ci95_upper"]:.6f}] std '
                  f'{r["std_score"]:.6f}')
        if [r['test_env'] for r in rows] != want or not all(
                r['ci95_lower'] <= r['mean_score'] <= r['ci95_upper']
                for r in rows):
            raise AssertionError(f'eval {demo}: rows {rows}')
        if n['K1'] < len(rows) or k4 < len(rows) or n['K2'] or n['K3']:
            raise AssertionError(f'eval {demo}: launches {n}')
        launches['K1'] += n['K1']
        launches['K4'] += k4
        first = ev.scores[demo]
        if ev.obtain_scores(demo) != first:
            raise AssertionError(f'eval {demo}: a second run with the same '
                                 f'seed gave other scores')
        tex = E.latexify_results(rows).strip().splitlines()
        if not (tex[1].startswith(r'\begin{tabular}')
                and tex[-2:] == [r'\bottomrule', r'\end{tabular}']
                and sum(ln.startswith(r'\textbf{uniform-random}')
                        for ln in tex) == 1):
            raise AssertionError(f'eval {demo}: latexify_results {tex}')
        print(f'[eval] {demo}: the same scores on a second run; '
              f'latexify_results: {len(tex)} lines, well formed')

    # one demo through the Gym adapter at hi (raw 384², K4), saved,
    # loaded and preprocessed
    env = registry.make(DEMO_ENV_NAME, fidelity='hi', device=DEVICE)
    env.seed(SEED)
    rng = np.random.default_rng(SEED)
    zero_counts()
    obs = [env.reset()]
    acts, rews, infos, done = [], [], [], False
    while not done:
        a = int(rng.integers(0, 18))
        o, r, done, info = env.step(a)
        acts.append(a)
        obs.append(o)
        rews.append(r)
        infos.append(info)
    n = read_counts()
    if n['K1'] != len(acts) or n['K4 frame'] < len(obs):
        raise AssertionError(f'eval demo: launches {n}')
    launches['K1'] += n['K1']
    launches['K4'] += n['K4 frame'] + n['K4 slot']
    traj = T.MAGICALTrajectory(acts=np.asarray(acts, np.int32), obs=obs,
                               rews=np.asarray(rews), infos=infos)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f'demo-{DEMO_ENV_NAME}-0.pkl.gz')
        T.save_demo(path, DEMO_ENV_NAME, traj, infos[-1]['eval_score'])
        (demo,) = T.load_demos([path])
    loaded = demo['trajectory']
    raw = {v: np.stack([o[v] for o in loaded.obs]) for v in ('allo', 'ego')}
    t0 = time.perf_counter()
    newest = {v: native.resize_area_batch(raw[v], 96) for v in raw}
    native_s = time.perf_counter() - t0
    # the same resize on the numpy fallback
    load, native._load = native._load, lambda: None
    try:
        t0 = time.perf_counter()
        np_newest = {v: native.resize_area_batch(raw[v], 96) for v in raw}
        numpy_s = time.perf_counter() - t0
    finally:
        native._load = load
    if not all(np.array_equal(np_newest[v], newest[v]) for v in raw):
        raise AssertionError('eval demo: the native and numpy resizes differ')
    n_raw = sum(len(x) for x in raw.values())
    print(f'[eval] INTER_AREA 384² -> 96² of the demo\'s {n_raw} raw frames: '
          f'{n_raw / native_s:.1f} frames/s on the native library, '
          f'{n_raw / numpy_s:.1f} on numpy, byte-equal')
    n_frames, t0 = 0, time.perf_counter()
    for name, spec in PREPROCESSORS.items():
        (out,) = T.preprocess_demos_with_wrapper(
            [loaded], demo['env_name'], preproc_name=name)
        n_frames += len(loaded.obs) * len(spec.views)
        if spec.stacked_dict:
            views = out.obs
        else:
            o = np.moveaxis(out.obs, 1, -1) if spec.channels_first \
                else out.obs
            views, c = {}, 0
            for v in spec.views:
                views[v] = o[..., c:c + 3 * spec.depth(v)]
                c += 3 * spec.depth(v)
            if c != o.shape[-1]:
                raise AssertionError(f'{name}: {o.shape[-1]} channels')
        for v, s in views.items():
            if s.shape != (len(loaded.obs), 96, 96, 3 * spec.depth(v)):
                raise AssertionError(f'{name} {v}: shape {s.shape}')
            if not np.array_equal(s[..., -3:], newest[v]):
                raise AssertionError(f'{name} {v}: the newest frame is not '
                                     f'the resized raw frame')
            if not np.array_equal(s[0], np.tile(newest[v][0],
                                                (1, 1, spec.depth(v)))):
                raise AssertionError(f'{name} {v}: obs 0 is not the reset '
                                     f'frame repeated')
    dt = time.perf_counter() - t0
    print(f'[eval] {DEMO_ENV_NAME} demo through the Gym adapter at hi: '
          f'{len(acts)} steps, raw 384² frames, score {demo["score"]}; '
          f'saved, loaded and preprocessed by the 5 preprocessors '
          f'({n_frames / dt:.1f} frames/s on the host): shapes right, obs 0 '
          f'the reset frame repeated, every newest frame byte-equal to '
          f'native.resize_area_batch of the raw frame; launches {n}')
    return launches


def welch_interval(mean_a, se_a, n_a, mean_b, se_b, n_b):
    """The 95% Welch interval of mean_a - mean_b from each mean's standard
    error and sample count."""
    from magical_tpu_torch.eval.protocol import _t_ppf
    se = (se_a ** 2 + se_b ** 2) ** 0.5
    df = se ** 4 / (se_a ** 4 / (n_a - 1) + se_b ** 4 / (n_b - 1))
    half = _t_ppf(0.975, df) * se
    d = mean_a - mean_b
    return d - half, d + half


def train_policy_on_the_card(smi):
    """The JAX-trained GAIL policy, read from its flax msgpack, on the
    card: greedy, stochastic and random rollouts of each TRAIN_ENVS env
    beside GAIL_RESULT.json's; its logits against the CPU's."""
    import torch
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.eval.protocol import _t_ppf, tconfint_mean
    from magical_tpu_torch.models.convert import (params_from_flax,
                                                  read_flax_msgpack)
    from magical_tpu_torch.models.nets import MagicalCNN
    from magical_tpu_torch.tools.train_gail_mtr import eval_random
    from magical_tpu_torch.train.bc import policy_of
    sd = params_from_flax(read_flax_msgpack(os.path.join(ROOT, JAX_POLICY)))
    with open(os.path.join(ROOT, JAX_RESULT)) as f:
        ref = json.load(f)
    n_ref = ref['random_baseline']['n']
    net = MagicalCNN(with_value_head=True)
    net.load_state_dict(sd)
    net.to(DEVICE)
    launches, kept = {}, {}
    for name in TRAIN_ENVS:
        variant = name.split('-')[1]
        env = BatchedEnv(name, device=DEVICE)
        zero_counts()
        t0 = time.perf_counter()
        rows = {}
        for kind, seed in (('greedy', SEED + 10), ('stoch', SEED + 11)):
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            carry, obs = env.reset(seed, POLICY_ROLLOUTS)
            _, last, *_, scores = env.rollout(
                carry, obs, policy_of(net, kind == 'greedy'), gen)
            rows[kind] = scores[-1].cpu().numpy()
        # the last observations of the stochastic rollouts
        kept[name] = last[:LOGIT_OBS // len(TRAIN_ENVS)]
        rows['random'] = eval_random(env, POLICY_ROLLOUTS, SEED + 12)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[name] = read_counts()
        print(f'[train] JAX policy on {name}: 3 x {POLICY_ROLLOUTS} '
              f'rollouts in {dt:.3f} s (host clock) on {smi}; launches '
              f'{launches[name]}')
        ci = {}
        for kind, sc in rows.items():
            ci[kind] = tconfint_mean(sc)
            r = ref['final_eval'].get(f'{variant}_{kind}')
            print(f'[train]   {kind}: mean {sc.mean():.6f} CI95 '
                  f'[{ci[kind][0]:.6f}, {ci[kind][1]:.6f}]; JAX '
                  + (f'{r["mean"]:.6f} CI95 [{r["ci"][0]:.6f}, '
                     f'{r["ci"][1]:.6f}] (n={n_ref})' if r else 'n/a'))
        if rows['greedy'].mean() < POLICY_MIN_GREEDY:
            raise AssertionError(f'{name}: the JAX policy scores '
                                 f'{rows["greedy"].mean()} greedy')
        if not ci['greedy'][0] > ci['random'][1]:
            raise AssertionError(f'{name}: greedy CI {ci["greedy"]} not '
                                 f'above random {ci["random"]}')
        js = ref['final_eval'][f'{variant}_stoch']
        se_j = (js['ci'][1] - js['ci'][0]) / 2 / _t_ppf(0.975, n_ref - 1)
        sc = rows['stoch']
        lo, hi = welch_interval(sc.mean(), sc.std(ddof=1) / len(sc) ** 0.5,
                                len(sc), js['mean'], se_j, n_ref)
        print(f'[train]   stochastic, port - JAX: 95% Welch interval '
              f'[{lo:.6f}, {hi:.6f}]')
        if not lo <= 0.0 <= hi:
            raise AssertionError(f'{name}: the stochastic mean differs from '
                                 f'JAX\'s: Welch interval [{lo}, {hi}]')

    # the network on the card against the same weights on the CPU
    obs = torch.cat(list(kept.values()))
    for dtype, rtol in ((torch.float32, NET_F32_RTOL),
                        (torch.bfloat16, NET_BF16_RTOL)):
        card_net, cpu_net = (MagicalCNN(with_value_head=True, dtype=dtype)
                             for _ in range(2))
        card_net.load_state_dict(sd)
        cpu_net.load_state_dict(sd)
        with torch.no_grad():
            got = card_net.to(DEVICE)(obs)[0].float().cpu()
            want = cpu_net(obs.cpu())[0].float()
        err = float((got - want).abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        print(f'[train] logits of the JAX policy on {len(obs)} observations '
              f'in {dtype}, card vs CPU: max |dlogit| {err:.3e} (largest '
              f'|logit| {float(want.abs().max()):.3f}), argmax agreement '
              f'{agree:.4f}')
        if err > rtol * float(want.abs().max()):
            raise AssertionError(f'{dtype} logits on the card vs the CPU: '
                                 f'{err}')
    return launches


def train_bc_on_the_card(smi):
    """BC from BC_DEMOS scripted-expert episodes of MoveToRegion-Demo:
    BC_STEPS AdamW steps, then a greedy evaluation of POLICY_ROLLOUTS
    envs.  Returns the expert data and the launch counts."""
    import numpy as np
    import torch
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.tools.train_gail_mtr import (collect_expert,
                                                        eval_policy)
    from magical_tpu_torch.train.bc import BCTrainer
    env = BatchedEnv(TRAIN_ENVS[0], device=DEVICE)
    zero_counts()
    ds_obs, ds_act, expert = collect_expert(env, BC_DEMOS)
    n_expert = read_counts()
    if expert.mean() < 0.9:
        raise AssertionError(f'the scripted expert scores {expert.mean()}')
    trainer = BCTrainer(tuple(ds_obs.shape[1:]), lr=BC_LR, seed=1,
                        device=DEVICE)
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(np.stack([
        rng.choice(len(ds_act), size=BC_BATCH, replace=False)
        for _ in range(BC_STEPS)]), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(BC_STEPS):
        m = trainer.train_step(ds_obs[idx[i]], ds_act[idx[i]])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f'[train] BC: {BC_DEMOS} expert episodes (score '
          f'{expert.mean():.3f}; launches {n_expert}), {BC_STEPS} AdamW '
          f'steps of {BC_BATCH} at lr {BC_LR} in {dt:.3f} s = '
          f'{BC_STEPS / dt:.1f} steps/s, {BC_STEPS * BC_BATCH / dt:.1f} '
          f'samples/s on {smi}; last loss {float(m["loss"]):.4f} acc '
          f'{float(m["acc"]):.3f}')
    zero_counts()
    scores, dist = eval_policy(env, trainer.net, POLICY_ROLLOUTS, SEED + 13)
    n_eval = read_counts()
    print(f'[train] BC greedy on {TRAIN_ENVS[0]}: mean {scores.mean():.6f} '
          f'over {POLICY_ROLLOUTS} envs, final distance {dist:.3f}; '
          f'launches {n_eval}')
    if scores.mean() < BC_MIN_SCORE:
        raise AssertionError(f'BC scores {scores.mean()} < {BC_MIN_SCORE}')
    return ds_obs, ds_act, {'expert': n_expert, 'eval': n_eval}


def train_gail_on_the_card(smi, ds_obs, ds_act):
    """GAIL_ITERS iterations of the GAIL script's loop on the card at
    GAIL_ENVS envs (GAIL_KW): both networks must move and stay finite; the
    card's busy share over the last iteration."""
    import numpy as np
    import torch
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.train.gail import GAILTrainer
    env = BatchedEnv(TRAIN_ENVS[0], device=DEVICE)
    tr = GAILTrainer(env, tuple(ds_obs.shape[1:]),
                     rollout_len=env.max_episode_steps, seed=SEED, **GAIL_KW)
    before = [p.detach().clone() for p in (*tr.policy.parameters(),
                                           *tr.disc.parameters())]
    rng = np.random.default_rng(SEED)
    reset_gen = torch.Generator().manual_seed(SEED)
    act_gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    n_pol = tr.rollout_len * GAIL_ENVS
    mb = n_pol // GAIL_MINIBATCHES
    n_disc = GAIL_DISC_BATCH + min(GAIL_DISC_BATCH, len(ds_act))

    def iteration(times):
        def clock():
            torch.cuda.synchronize()
            return time.perf_counter()
        t0 = clock()
        carry, obs = env.reset(reset_gen, GAIL_ENVS)
        carry, obs, traj = tr.collect(carry, obs, act_gen)
        t1 = clock()
        for _ in range(GAIL_PPO_EPOCHS):
            perm = rng.permutation(n_pol)
            for m in range(GAIL_MINIBATCHES):
                pm = tr.ppo_update(traj, perm[m * mb:(m + 1) * mb])
        t2 = clock()
        ip = rng.choice(n_pol, size=GAIL_DISC_BATCH, replace=False)
        ie = rng.choice(len(ds_act), size=min(GAIL_DISC_BATCH, len(ds_act)),
                        replace=False)
        dm = tr.disc_update(traj['obs'], traj['act'], ip, ds_obs, ds_act, ie)
        t3 = clock()
        times.append((t1 - t0, t2 - t1, t3 - t2))
        return pm, dm, traj

    zero_counts()
    times = []
    for _ in range(GAIL_ITERS - 1):
        iteration(times)
    (pm, dm, traj), busy, _ = busy_share(lambda: iteration(times))
    n = read_counts()
    after = [p.detach() for p in (*tr.policy.parameters(),
                                  *tr.disc.parameters())]
    n_pol_params = len(list(tr.policy.parameters()))
    moved = [not torch.equal(a, b) for a, b in zip(before, after)]
    finite = all(bool(torch.isfinite(a).all()) for a in after)
    c, p, d = (min(t[k] for t in times) for k in range(3))
    print(f'[train] GAIL: {GAIL_ITERS} iterations at {GAIL_ENVS} envs x '
          f'{tr.rollout_len} steps on {smi}: collection {c:.3f} s = '
          f'{n_pol / c:.1f} env-steps/s; PPO {GAIL_PPO_EPOCHS} x '
          f'{GAIL_MINIBATCHES} minibatches {p:.3f} s = '
          f'{GAIL_PPO_EPOCHS * n_pol / p:.1f} samples/s; discriminator '
          f'{d:.3f} s = {n_disc / d:.1f} samples/s (fastest iteration of '
          f'each); card busy '
          + ('not measured' if busy is None else f'{busy:.1%}')
          + f' of the last iteration; launches {n}')
    print(f'[train] GAIL last: pg {float(pm["pg"]):+.4f} vloss '
          f'{float(pm["vloss"]):.4f} entropy {float(pm["entropy"]):.4f} '
          f'disc_loss {float(dm["disc_loss"]):.4f} disc_acc '
          f'{float(dm["disc_acc"]):.4f} reward mean '
          f'{float(traj["reward"].mean()):+.4f}; obs {tuple(traj["obs"].shape)}')
    if not (any(moved[:n_pol_params]) and any(moved[n_pol_params:])
            and finite):
        raise AssertionError(f'GAIL: policy moved {any(moved[:n_pol_params])}'
                             f', discriminator moved '
                             f'{any(moved[n_pol_params:])}, finite {finite}')
    if n['K1'] != GAIL_ITERS * tr.rollout_len or n['K2'] != n['K1']:
        raise AssertionError(f'GAIL launches {n}')
    return n, min(sum(t) for t in times)


def phase_train(smi):
    """The learner on the card (module docstring, phase 12); returns K1's,
    K2's and K3's launches by part."""
    launches = {'policy': train_policy_on_the_card(smi)}
    ds_obs, ds_act, launches['bc'] = train_bc_on_the_card(smi)
    launches['gail'], gail_s = train_gail_on_the_card(smi, ds_obs, ds_act)
    return launches, gail_s


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


class LastStep:
    """An env whose every step leaves its output in `.last`: the carry and
    observation that rollout_episodes ends on, which it does not return."""

    def __init__(self, env):
        self.env, self.last = env, None

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, *a, **kw):
        self.last = self.env.reset(*a, **kw)
        return self.last

    def step(self, *a, **kw):
        out = self.env.step(*a, **kw)
        self.last = out[:2]
        return out


def same_end(a, b):
    """Whether two (carry, obs) are equal bit for bit: every field of the
    env state, every frame ring and the observation."""
    import dataclasses
    import torch
    (ca, oa), (cb, ob) = a, b
    fields = [f.name for f in dataclasses.fields(ca.state)]
    return (ca.t == cb.t and torch.equal(oa, ob)
            and all(torch.equal(getattr(ca.state, f), getattr(cb.state, f))
                    for f in fields)
            and ca.frames.keys() == cb.frames.keys()
            and all(torch.equal(ca.frames[k], cb.frames[k])
                    for k in ca.frames))


def dist_rollout(smi, mesh, main_rate):
    """rollout_episodes over the NCCL mesh at MAIN_BATCH envs of ENV_NAME,
    its steady steps timed as `main` times its own, against
    BatchedEnv.rollout from the same seed and random-action draws: the
    scores, the end state, the frame rings and the last observation."""
    import torch
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.parallel import mesh as M
    from magical_tpu_torch.parallel import rollout as R
    env = BatchedEnv(ENV_NAME, device=DEVICE)
    B, T, warm = MAIN_BATCH, env.max_episode_steps, 5
    local, start = M.data_rows(mesh, B)
    random = R.random_policy(local, B, start)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    calls = []

    def policy(obs, gen):
        if len(calls) == warm:
            events[0].record()
        calls.append(1)
        return random(obs, gen)
    recorded = LastStep(env)
    zero_counts()
    scores = R.rollout_episodes(recorded, policy, SEED + 20, B, mesh=mesh)
    events[1].record()
    torch.cuda.synchronize()
    n = read_counts()
    ms = events[0].elapsed_time(events[1])
    rate = B * (T - warm) / (ms / 1e3)
    # the same episode through BatchedEnv.rollout, one process
    carry, obs = env.reset(torch.Generator().manual_seed(SEED + 20), B)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    carry, obs, _, dones, ref = env.rollout(carry, obs, R.random_policy(B),
                                            gen)
    same_scores = (scores.shape == ref[-1].shape
                   and bool(torch.equal(scores, ref[-1])))
    same_state = same_end(recorded.last, (carry, obs))
    print(f'[dist] rollout_episodes {ENV_NAME} B={B} over NCCL (world size '
          f'{torch.distributed.get_world_size()}, mesh '
          f'{tuple(mesh.shape)}): {T - warm} steady steps in {ms:.3f} ms = '
          f'{rate:.1f} env-steps/s ([main] {main_rate:.1f}, ratio '
          f'{rate / main_rate:.4f}) on {smi}; launches {n}; scores mean '
          f'{float(scores.mean()):.6f}, bit for bit BatchedEnv.rollout\'s: '
          f'scores {same_scores}, end state, frame rings and last '
          f'observation {same_state}')
    if not (same_scores and same_state):
        raise AssertionError('rollout_episodes differs from '
                             'BatchedEnv.rollout')
    if n['K1'] != T or n['K2'] != T or n['K3'] < 1:
        raise AssertionError(f'[dist] rollout launches {n}')
    tp = R.env_throughput(env, B, n_steps=30, warmup=3, seed=SEED)
    print(f'[dist] env_throughput {ENV_NAME} B={B}: {tp:.1f} env-steps/s '
          f'(30 no-op steps after 3, CUDA events)')
    return n, rate, tp


def dist_bc(smi, mesh):
    """A full-width BC step over the mesh against the same step with no
    mesh, under cudnn.deterministic: bit for bit."""
    import numpy as np
    import torch
    from magical_tpu_torch.train.bc import BCTrainer
    rng = np.random.default_rng(SEED + 21)
    obs = torch.as_tensor(rng.integers(0, 256, (BC_BATCH, 96, 96, 12),
                                       dtype=np.uint8), device=DEVICE)
    act = torch.as_tensor(rng.integers(0, 18, BC_BATCH), device=DEVICE)
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for m in (None, mesh):
            tr = BCTrainer((96, 96, 12), lr=BC_LR, seed=1, device=DEVICE,
                           mesh=m)
            tr.train_step(obs, act)
            metrics = tr.train_step(obs, act)
            out.append((metrics, tr.net.state_dict()))
    finally:
        torch.backends.cudnn.deterministic = False
    (m0, p0), (m1, p1) = out
    same = (all(torch.equal(p0[k], p1[k]) for k in p0)
            and torch.equal(m0['loss'], m1['loss']))
    worst = max(float((p0[k] - p1[k]).abs().max()) for k in p0)
    print(f'[dist] BC over the mesh, MagicalCNN 64/128/128/256 bf16, '
          f'96x96x12, batch {BC_BATCH}, 2 AdamW steps against the same '
          f'steps with no mesh (cudnn.deterministic): bit for bit {same} '
          f'(max |dparam| {worst:.3e}); loss {float(m1["loss"]):.6f}')
    if not same:
        raise AssertionError('[dist] BC over the mesh differs from the '
                             'step with no mesh')


def dist_gail(smi, mesh, train_gail_s):
    """GAIL iterations over the mesh at GAIL_ENVS envs x 40 steps, as
    `train`'s iteration (its minibatches and discriminator batch): two
    timed, then one over the mesh against the same iteration with no mesh
    on the same inputs, under cudnn.deterministic: bit for bit."""
    import numpy as np
    import torch
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.train.gail import GAILTrainer
    env = BatchedEnv(TRAIN_ENVS[0], device=DEVICE)
    rng = np.random.default_rng(SEED)
    exp_obs = torch.as_tensor(rng.integers(
        0, 256, (GAIL_DISC_BATCH, 96, 96, 12), dtype=np.uint8), device=DEVICE)
    exp_act = torch.as_tensor(rng.integers(0, 18, GAIL_DISC_BATCH),
                              device=DEVICE)
    n_pol = env.max_episode_steps * GAIL_ENVS
    mb = n_pol // GAIL_MINIBATCHES

    def trainer(m):
        return GAILTrainer(env, (96, 96, 12),
                           rollout_len=env.max_episode_steps, seed=SEED,
                           mesh=m, **GAIL_KW)

    def iteration(tr, rng):
        carry, obs = env.reset(SEED, GAIL_ENVS, global_batch=GAIL_ENVS)
        carry, obs, traj = tr.collect(
            carry, obs, torch.Generator(device=DEVICE).manual_seed(SEED))
        for _ in range(GAIL_PPO_EPOCHS):
            perm = rng.permutation(n_pol)
            for m in range(GAIL_MINIBATCHES):
                pm = tr.ppo_update(traj, perm[m * mb:(m + 1) * mb])
        dm = tr.disc_update(traj['obs'], traj['act'],
                            rng.choice(n_pol, GAIL_DISC_BATCH, replace=False),
                            exp_obs, exp_act, np.arange(GAIL_DISC_BATCH))
        return pm, dm

    tr = trainer(mesh)
    seconds = []
    zero_counts()
    for _ in range(2):          # the first builds cuDNN's plans
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pm, dm = iteration(tr, rng)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    n = read_counts()
    finite = all(bool(torch.isfinite(p).all()) for p in
                 (*tr.policy.parameters(), *tr.disc.parameters()))
    print(f'[dist] GAIL over the mesh: an iteration at {GAIL_ENVS} envs x '
          f'{tr.rollout_len} steps, PPO {GAIL_PPO_EPOCHS} x '
          f'{GAIL_MINIBATCHES} minibatches, discriminator {GAIL_DISC_BATCH} '
          f'+ {GAIL_DISC_BATCH}: {seconds[-1]:.3f} s (first '
          f'{seconds[0]:.3f} s; [train]\'s fastest {train_gail_s:.3f} s, '
          f'ratio {seconds[-1] / train_gail_s:.4f}) on {smi}; pg '
          f'{float(pm["pg"]):+.4f} disc_acc {float(dm["disc_acc"]):.4f}; '
          f'launches {n}; finite {finite}')
    if not finite or n['K1'] != 2 * tr.rollout_len:
        raise AssertionError(f'[dist] GAIL: finite {finite}, launches {n}')

    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for m in (None, mesh):
            tr = trainer(m)
            metrics = iteration(tr, np.random.default_rng(SEED + 22))
            out.append((metrics, {**tr.policy.state_dict(), **{
                f'disc.{k}': v for k, v in tr.disc.state_dict().items()}}))
    finally:
        torch.backends.cudnn.deterministic = False
    ((pm0, dm0), p0), ((pm1, dm1), p1) = out
    same = (all(torch.equal(p0[k], p1[k]) for k in p0)
            and all(torch.equal(a[k], b[k]) for a, b in ((pm0, pm1),
                                                        (dm0, dm1))
                    for k in a))
    worst = max(float((p0[k].float() - p1[k].float()).abs().max())
                for k in p0)
    print(f'[dist] GAIL over the mesh against the same iteration with no '
          f'mesh on the same inputs (cudnn.deterministic): bit for bit '
          f'{same} (max |dparam| {worst:.3e}); pg {float(pm1["pg"]):+.6f} '
          f'disc_loss {float(dm1["disc_loss"]):.6f} disc_acc '
          f'{float(dm1["disc_acc"]):.4f}')
    if not same:
        raise AssertionError('[dist] GAIL over the mesh differs from the '
                             'iteration with no mesh')
    return n, seconds[-1]


def phase_dist(smi, main_rate, train_gail_s):
    """The data-parallel path on an NCCL group of one rank (this machine
    has one card, and NCCL takes one rank a card): rollout_episodes at the
    main path's width, env_throughput, a BC step and a GAIL iteration over
    the mesh.  Returns the rollout's launches."""
    import torch
    import torch.distributed as dist
    from magical_tpu_torch.parallel import mesh as M
    torch.cuda.set_device(0)
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:'
                            f'{free_port()}', world_size=1, rank=0)
    try:
        if dist.get_backend() != 'nccl':
            raise AssertionError(f'[dist] backend {dist.get_backend()}')
        mesh = M.make_mesh()
        # NCCL sets up its communicator at the first collective: take it
        # here, outside the timed rollout
        t0 = time.perf_counter()
        one = torch.ones(1, device=DEVICE)
        dist.all_reduce(one, group=mesh.get_group('data'))
        torch.cuda.synchronize()
        print(f'[dist] NCCL group of one rank, mesh {tuple(mesh.shape)} '
              f"('data', 'model'): first all_reduce (the communicator's "
              f'set-up) {time.perf_counter() - t0:.3f} s')
        n, rate, tp = dist_rollout(smi, mesh, main_rate)
        dist_bc(smi, mesh)
        n_gail, gail_s = dist_gail(smi, mesh, train_gail_s)
    finally:
        dist.destroy_process_group()
    return {'rollout': n, 'gail': n_gail, 'rate': rate, 'throughput': tp,
            'gail_s': gail_s}


def decode_png_size(png):
    import struct
    if png[:8] != b'\x89PNG\r\n\x1a\n' or png[12:16] != b'IHDR':
        raise AssertionError('not a PNG')
    return struct.unpack('>II', png[16:24])


def http(url, data=None):
    import urllib.request
    with urllib.request.urlopen(url, data=data, timeout=30) as r:
        return r.read()


def phase_tools(smi):
    """The CLI and the tools on the card: `python -m magical_tpu_torch
    --policy random --record` on TOOLS_ENV in a process of its own, the
    demo re-recorded at hi (equal actions and score: the Demo reset is
    deterministic), rendered to video or frames, and the viewer
    (`--serve`) in a process of its own on a free loopback port."""
    import shutil
    from magical_tpu_torch.data.trajectories import load_demos
    from magical_tpu_torch.tools import render_demos
    from magical_tpu_torch.tools.re_record_demos import re_record
    out = os.path.join(ROOT, 'build', 'chip_tools')
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, '-m', 'magical_tpu_torch',
                        '--env-name', TOOLS_ENV, '--policy', 'random',
                        '--episodes', '1', '--record', out, '--seed', '0'],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    cli_s = time.perf_counter() - t0
    if r.returncode:
        raise AssertionError(f'[tools] CLI failed:\n{r.stderr[-3000:]}')
    (demo_path,) = [os.path.join(out, f) for f in os.listdir(out)]
    (demo,) = load_demos([demo_path])
    print(f'[tools] python -m magical_tpu_torch --env-name {TOOLS_ENV} '
          f'--policy random --record: {cli_s:.1f} s (a process of its own, '
          f'start-up included); {r.stdout.strip().splitlines()[0]}')
    zero_counts()
    t0 = time.perf_counter()
    (rr_path,) = re_record(TOOLS_ENV, [demo_path], os.path.join(out, 'rr'),
                           fidelity='hi', verbose=False, device=DEVICE)
    rr_s = time.perf_counter() - t0
    n = read_counts()
    (rr,) = load_demos([rr_path])
    same = (list(rr['trajectory'].acts) == list(demo['trajectory'].acts)
            and rr['score'] == demo['score'])
    print(f'[tools] re_record at hi: {rr_s:.2f} s, {len(rr["trajectory"].obs)}'
          f' observations, score {rr["score"]} against the demo\'s '
          f'{demo["score"]}, equal actions and score {same}; launches {n}')
    if not same or n['K4 frame'] < 1:
        raise AssertionError(f'[tools] re_record: equal {same}, launches {n}')
    (video,) = render_demos.main([rr_path, '--out-dir',
                                  os.path.join(out, 'video')])
    print(f'[tools] render_demos: '
          + ('ffmpeg, ' + video if video.endswith('.mp4') else
             f'no ffmpeg, {len(os.listdir(video))} PPM frames in {video}'))
    port = free_port()
    log = open(os.path.join(out, 'serve.log'), 'wb')
    proc = subprocess.Popen([sys.executable, '-m', 'magical_tpu_torch',
                             '--env-name', TOOLS_ENV, '--serve', str(port)],
                            env=env, cwd=ROOT, stdout=log, stderr=log)
    base = f'http://127.0.0.1:{port}'
    try:
        t0 = time.perf_counter()
        size = None
        while time.perf_counter() - t0 < 120 and size != (384, 384):
            try:
                size = decode_png_size(http(base + '/frame.png'))
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError('[tools] --serve exited')
            time.sleep(0.2)
        up_s = time.perf_counter() - t0
        state = json.loads(http(base + '/state'))
        http(base + '/keys', json.dumps(['up']).encode())
        t1 = time.perf_counter()
        later = state
        while time.perf_counter() - t1 < 30 and later['t'] <= state['t']:
            time.sleep(0.25)
            later = json.loads(http(base + '/state'))
        page = http(base + '/')
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
    print(f'[tools] --serve on 127.0.0.1:{port}: first frame after '
          f'{up_s:.1f} s, /frame.png {size[0]}x{size[1]}, /state t '
          f'{state["t"]} -> {later["t"]} after POST /keys, recording '
          f'{later["recording"]}; / {len(page)} bytes')
    if size != (384, 384) or later['t'] <= state['t'] or b'/keys' not in page:
        raise AssertionError('[tools] the viewer did not serve')


def phase_sweep(smi):
    """tools/id_sweep.py over every registered ID on the card, from an
    empty ledger under build/: one whole random episode each at batch 2;
    any failure fails the run."""
    from magical_tpu_torch.tools import id_sweep
    ledger = os.path.join(ROOT, 'build', 'chip_sweep', 'id_sweep.txt')
    if os.path.exists(ledger):
        os.remove(ledger)
    zero_counts()
    out = id_sweep.main(['--ledger', ledger, '--device', DEVICE])
    n = read_counts()
    print(f'[sweep] {out["green"]}/{out["total"]} IDs green in '
          f'{out["seconds"]:.1f} s ({out["steps"]} steps at batch '
          f'{id_sweep.BATCH}, {out["steps"] / out["seconds"]:.1f} steps/s) '
          f'on {smi}; launches {n}')
    if out['failed'] or out['green'] != out['total'] or out['total'] != 366:
        raise AssertionError(f'[sweep] failed: {out["failed"]}')
    if min(n['K1'], n['K2'], n['K3']) < 1:
        raise AssertionError(f'[sweep] launches {n}')
    return n


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
    wall = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        wall[phase] = time.perf_counter() - t0
        print(f'[{phase}] phase wall time {wall[phase]:.1f} s')
        return out

    smi = timed('device', phase_device)
    timed('build', phase_build)
    kerr = timed('kernels', phase_kernels)
    env, carry, launches, rate = timed('main', phase_main, smi)
    errs = phase_main_shapes(env, carry)
    hi_env, hi_carry, hi_k1, hi_k4, hi_err, hi_rate = timed('hi', phase_hi,
                                                            smi)
    gym_err = timed('gym', phase_gym)
    multi = timed('multi', phase_multi, smi, rate)
    lo_env, lo_carry, lo_launch = multi['p138 lo']
    wide_env, wide_carry, hi_launch = multi['p138 hi']
    cases = [('K1 mb1', 'K1', env, carry, None)]
    cases += [(f'K1 mb{mb}', 'K1', e, c, None)
              for mb, (e, c) in sorted(multi['K1 carries'].items())]
    cases += [('K1 mb10 TestAll', 'K1', lo_env, lo_carry, None),
              ('K2', 'K2', env, carry, None), ('K3', 'K3', env, carry, None),
              ('K4', 'K4', hi_env, hi_carry, None),
              ('K2 p138', 'K2', lo_env, lo_carry, None),
              ('K3 p138', 'K3', lo_env, lo_carry, None),
              ('K4 p138', 'K4', wide_env, wide_carry, None)]
    cases += [(f'K5 {r}x{c}', 'K5', lo_env, lo_carry, (r, c))
              for r, c in TILES]
    times = timed('times', phase_times, cases)
    step_rest(env, carry)
    step_rest(lo_env, lo_carry)
    _, episode = timed('episode', phase_episode)
    timed('determinism', phase_determinism, lo_carry.state)
    timed('parity', phase_parity)
    timed('eval', phase_eval, smi)
    train_launches, train_gail_s = timed('train', phase_train, smi)
    dist_out = timed('dist', phase_dist, smi, rate, train_gail_s)
    timed('tools', phase_tools, smi)
    sweep_launches = timed('sweep', phase_sweep, smi)
    launches['K4'] = hi_k4
    errs['K1'] = max(errs['K1'], kerr['K1'][1])
    for k in ('K2', 'K3'):
        errs[k] = max(errs[k], kerr[k])
    errs['K4'] = max(kerr['K4'], hi_err, gym_err)

    rows = [('K1', 'physics_control_step', 'physics_step.cu', 1262,
             launches['K1'], errs['K1'], times['K1 mb1'])]
    for mb in sorted(multi['K1 carries']):
        rows.append(('K1', f'physics_control_step_mb{mb}',
                     f'physics_step_mb{mb}.cu', 1262,
                     multi['K1 launches'][mb], kerr['K1'][mb],
                     times[f'K1 mb{mb}']))
    t5 = f'K5 {TILES[0][0]}x{TILES[0][1]}'
    rows += [
        ('K2', 'render_lo_into_slot', 'render_lo.cu', 918, launches['K2'],
         errs['K2'], times['K2']),
        ('K2', 'render_lo_into_slot_p138', 'render_lo.cu', 918,
         lo_launch['K2'], kerr['K2'], times['K2 p138']),
        ('K3', 'render_lo_frame', 'render_lo.cu', 766, launches['K3'],
         errs['K3'], times['K3']),
        ('K3', 'render_lo_frame_p138', 'render_lo.cu', 766, lo_launch['K3'],
         kerr['K3'], times['K3 p138']),
        ('K4', 'render_hi', 'render_hi.cu', 517, launches['K4'], errs['K4'],
         times['K4']),
        ('K4', 'render_hi_p138', 'render_hi.cu', 517,
         hi_launch['K4 frame'] + hi_launch['K4 slot'], kerr['K4'],
         times['K4 p138']),
        ('K5', 'render_lo_tiles2d', 'render_lo.cu', 692,
         multi['K5 launches'], kerr['K5'], times[t5])]
    kernels = []
    for k, name, src, line, n, err, t in rows:
        bound_ms, bound_by = bound(t['ops'], t['bytes'])
        pallas = 'physics_pallas.py' if k == 'K1' else 'render_pallas.py'
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'magical_tpu_torch/csrc/{src}',
            'replaces': f'magical_tpu/core/{pallas}:{line}',
            'launches': n, 'max_abs_err': err, 'ms': t['ms'],
            'plain_ms': t['plain_ms'], 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': None})
    print(f'[result] env-steps/s {rate:.1f} (lo main), {hi_rate:.1f} (hi, '
          f'K1 {hi_k1} and K4 {hi_k4} launches); mean over the families '
          f'{multi["mean"][0]:.1f} (n_tasks={multi["mean"][1]}); on {smi}')
    print(f'[result] [dist] rollout_episodes over NCCL {dist_out["rate"]:.1f} '
          f'env-steps/s, env_throughput {dist_out["throughput"]:.1f}, a GAIL '
          f'iteration over the mesh {dist_out["gail_s"]:.3f} s ([train] '
          f'{train_gail_s:.3f} s); [sweep] launches {sweep_launches}; '
          f'[train] launches {train_launches}')
    print('[result] [episode] K1 against the reference\'s hold: '
          + ', '.join(f'{p} part T {v["T"]:.4f}, draws\' largest '
                      f'{v["T_draws_max"]:.4f}, level {v["level"]:.4f}'
                      for p, v in episode.items()))
    print('[result] phase wall times: '
          + ', '.join(f'{k} {v:.1f} s' for k, v in wall.items()))
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
