"""Write tests/fixtures/torch_chaos_floor.json: the 1-ulp self-divergence
of magical_tpu_torch's own plain physics over the episodes of
tests/fixtures/torch_episode_reference.npz, and the gate that
chip_smoke.py's `[episode]` phase holds the control-step kernel to.

This is scripts/chaos_floor.py's experiment run on the port's plain path
instead of the reference's XLA path: the same episode twice, identical
except that every initial position is moved 1 ulp, and the end positions
compared by the same statistics (`dpos` median, 90th percentile, share
within 0.05).  The reference ran it once, every position up
(tests/fixtures/chaos_floor.json).  Here it runs N_DRAWS times: draw 0
moves every position up, as the reference did, and draw k > 0 moves each
position coordinate up or down by a sign drawn from RandomState(k).  The
fixture's 64 Demo resets are identical, so one env is stepped and its end
state repeated 64 times before the statistics, which then equal those of
64 envs; so each draw is one draw of the chaotic divergence of one
trajectory, and the draws give its distribution.

`gate` is, for each statistic, the looser of the reference's bound and
the GATE_QUANTILE quantile of the port's draws (the 1 - GATE_QUANTILE
quantile of the share within 0.05): a path that rounds apart from the
reference (a GPU kernel's sums and libm) lands on one such draw, and one
in ten 1-ulp draws of the plain path lies beyond this gate.  The plain
path itself is held to the reference's bound alone
(tests/test_torch_episode.py).

Beside them runs the control-step kernel's own arithmetic (K1,
``csrc/physics_step.cuh``) built for the host with ``-ffp-contract=off``
through tests/kernel_host_shim.cpp, as tests/test_torch_kernel_host.py
builds it: the step at which it first leaves the plain path by more than
1e-5 (a body's position), and how far the 1-ulp draws have left the
plain path by then, bisect a divergence of the kernel from the reference.

Run (no JAX; MatchRegions ~10 minutes and ClusterColour ~40 on 4 CPU
threads; name tasks to rewrite only their entries, e.g. in two
processes):

    python tests/_torch_chaos_floor.py [MatchRegions] [ClusterColour]
"""

import ctypes
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIXTURE = os.path.join(REPO, 'tests', 'fixtures',
                       'torch_episode_reference.npz')
REFERENCE = os.path.join(REPO, 'tests', 'fixtures', 'chaos_floor.json')
OUT = os.path.join(REPO, 'tests', 'fixtures', 'torch_chaos_floor.json')
TASKS = ('MatchRegions', 'ClusterColour')
N_DRAWS = 64
GATE_QUANTILE = 0.9
STATS = ('dpos_median', 'dpos_p90', 'frac_within_0p05')
BISECT_ATOL = 1e-5


def dpos_stats(pos, ref_pos):
    """scripts/chaos_floor.py:83-95's statistics of two end states."""
    dpos = np.linalg.norm(np.asarray(pos, np.float32)
                          - np.asarray(ref_pos, np.float32), axis=-1)
    return dict(dpos_median=float(np.median(dpos)),
                dpos_p90=float(np.percentile(dpos, 90)),
                frac_within_0p05=float((dpos < 0.05).mean()))


def nudge_up(k, shape):
    """Which position coordinates draw k moves up (the rest go down)."""
    if k == 0:
        return np.ones(shape, bool)
    return np.random.RandomState(k).randint(0, 2, shape).astype(bool)


def gate(reference, draws):
    """Per statistic, the looser of the reference's bound and the
    GATE_QUANTILE quantile of the draws ({statistic: [one a draw]})."""
    q = 100 * GATE_QUANTILE
    return dict(
        dpos_median=max(reference['dpos_median'],
                        float(np.percentile(draws['dpos_median'], q))),
        dpos_p90=max(reference['dpos_p90'],
                     float(np.percentile(draws['dpos_p90'], q))),
        frac_within_0p05=min(reference['frac_within_0p05'],
                             float(np.percentile(draws['frac_within_0p05'],
                                                 100 - q))))


def host_kernel(tmp):
    """K1's arithmetic built for the host: physics_control_step."""
    from magical_tpu_torch import _build
    cxx = shutil.which('c++') or shutil.which('g++')
    out = os.path.join(tmp, 'libkernel_host.so')
    subprocess.run(
        [cxx, '-O2', '-std=c++17', '-ffp-contract=off', '-shared', '-fPIC',
         '-I', str(_build.CSRC_DIR), '-o', out,
         os.path.join(REPO, 'tests', 'kernel_host_shim.cpp')],
        check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(out).physics_control_step
    fn.argtypes = _build.SIGNATURES['physics_control_step_mb1']
    fn.restype = ctypes.c_int
    return fn


def floor_of(task, data, kernel, reference):
    """The entry of `task`: the draws' statistics, the gate, and the plain
    path and the host-built kernel against the reference."""
    import torch

    from magical_tpu_torch import constants as C
    from magical_tpu_torch.core import physics, physics_kernel
    from magical_tpu_torch.core.convert import state_from_numpy
    from magical_tpu_torch.core.state import EnvState
    from magical_tpu_torch.tasks import ALL_TASKS

    reset = {f.name: data[f'{task}/reset/{f.name}']
             for f in dataclasses.fields(EnvState)}
    B = len(reset['pos'])
    if not all((v == v[:1]).all() for v in reset.values()):
        raise SystemExit(f'{task}: the fixture resets differ; step all {B} '
                         f'envs')
    # env 0, then env 0 under each draw, in one batch
    rows = {k: np.repeat(v[:1], N_DRAWS + 1, 0) for k, v in reset.items()}
    pos = rows['pos'][1:]
    for k in range(N_DRAWS):
        pos[k] = np.where(nudge_up(k, pos[k].shape),
                          np.nextafter(pos[k], np.float32(np.inf)),
                          np.nextafter(pos[k], np.float32(-np.inf)))
    st = state_from_numpy(rows, 'cpu')
    sk = state_from_numpy({k: v[:1] for k, v in reset.items()}, 'cpu')
    ftab, itab, _ = physics_kernel.table_arrays(sk.max_blocks)
    ftab, itab = torch.from_numpy(ftab), torch.from_numpy(itab)
    n_steps = ALL_TASKS[task].ep_len
    bisect = None
    for t, a in enumerate(data['actions'][:n_steps], 1):
        act = torch.full((N_DRAWS + 1,), int(a), dtype=torch.int32)
        physics_kernel.check_inputs(sk, act[:1])
        if kernel(*physics_kernel.kernel_args(
                sk, act[:1], ftab, itab, phys_steps=C.PHYS_STEPS),
                None) != 0:
            raise SystemExit('the host kernel failed')
        st = physics.control_step(st, act)
        k_off = float((sk.pos[0] - st.pos[0]).norm(dim=-1).max())
        if bisect is None and k_off > BISECT_ATOL:
            off = (st.pos[1:] - st.pos[:1]).norm(dim=-1).amax(-1).numpy()
            bisect = {'step': t, 'kernel_vs_plain': k_off,
                      'draws_vs_plain': dict(
                          min=float(off.min()), median=float(np.median(off)),
                          max=float(off.max()))}
        if t % 20 == 0:
            print(f'{task}: step {t} of {n_steps}', flush=True)
    end = np.repeat(st.pos.numpy()[:, None], B, 1)      # (rows, B, NB, 2)
    k_end = np.repeat(sk.pos.numpy(), B, 0)
    ref = data[f'{task}/end/pos']
    per_draw = [dpos_stats(end[k + 1], end[0]) for k in range(N_DRAWS)]
    draws = {s: [d[s] for d in per_draw] for s in STATS}
    return {'B': B, 'n_steps': n_steps, 'perturb': '1 ulp on pos',
            **per_draw[0],
            'draws': {'perturb': '1 ulp on every pos coordinate; draw 0 all '
                                 'up, draw k > 0 up or down by '
                                 'RandomState(k)',
                      'n': N_DRAWS, **draws},
            'gate': {**gate(reference, draws),
                     'rule': f'per statistic the looser of chaos_floor.json '
                             f'and the {GATE_QUANTILE} quantile of the draws '
                             f'(the share within 0.05: the '
                             f'{1 - GATE_QUANTILE:.1f} quantile)'},
            'plain_vs_reference': dpos_stats(end[0], ref),
            'host_kernel_vs_reference': dpos_stats(k_end, ref),
            'host_kernel_vs_plain': dpos_stats(k_end, end[0]),
            'bisect': bisect}


def main(tasks):
    import torch

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    tmp = tempfile.mkdtemp()
    try:
        kernel = host_kernel(tmp)
    finally:
        shutil.rmtree(tmp)
    with np.load(FIXTURE) as f:
        data = {k: f[k] for k in f.files}
    with open(REFERENCE) as f:
        reference = json.load(f)
    rows = {task: floor_of(task, data, kernel, reference[task])
            for task in tasks}
    # other tasks' entries stay as they are
    out = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            out = json.load(f)
    out.update(rows)
    with open(OUT, 'w') as f:
        json.dump({t: out[t] for t in TASKS if t in out}, f, indent=1)
    for task, row in rows.items():
        print(task, json.dumps({k: row[k] for k in (
            *STATS, 'gate', 'plain_vs_reference', 'host_kernel_vs_reference',
            'bisect')}), flush=True)
    print(f'wrote {OUT}', flush=True)


if __name__ == '__main__':
    main(sys.argv[1:] or TASKS)
