"""Write tests/fixtures/torch_chaos_floor.json: a bisect of the
control-step kernel's own arithmetic (K1, ``csrc/physics_step.cuh``), built
for the host with ``-ffp-contract=off`` through tests/kernel_host_shim.cpp
as tests/test_torch_kernel_host.py builds it, against the port's plain
physics over env 0 of each leg of tests/fixtures/torch_episode_reference.npz
(scripts/chaos_floor.py's action script from the Demo reset).

Beside them run N_NUDGES 1-ulp draws of the plain path from env 0's reset
(each position coordinate moved up or down by
tests/_torch_episode_fixture.nudge_up).  The step at which the host-built
kernel first leaves the plain path by more than BISECT_ATOL (a body's
position), and how far the draws have left the plain path by then, tell a
fault of the kernel from a difference in rounding; the end poses of the
kernel and of the plain path are compared with the reference's env 0 by
the fixture's `dpos_stats` (over that env's bodies).

No gate reads this file: the port is held to the reference's own 1-ulp
floor over the fixture's 64 trajectories (torch_episode_floor.json).

Run (no JAX; a few minutes on 4 CPU threads, most of it ClusterColour):

    python tests/_torch_chaos_floor.py [TASK ...]
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
sys.path.insert(0, os.path.join(REPO, 'tests'))

from _torch_episode_fixture import (OUT as FIXTURE, TASKS,  # noqa: E402
                                    dpos_stats, nudged)

OUT = os.path.join(REPO, 'tests', 'fixtures', 'torch_chaos_floor.json')
N_NUDGES = 16
BISECT_ATOL = 1e-5


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


def bisect_of(task, data, kernel):
    """The entry of `task`: the host-built kernel and the plain path from
    env 0, against each other, the draws and the reference."""
    import torch

    from magical_tpu_torch import constants as C
    from magical_tpu_torch.core import physics, physics_kernel
    from magical_tpu_torch.core.convert import state_from_numpy
    from magical_tpu_torch.core.state import EnvState

    reset = {f.name: data[f'{task}/reset/{f.name}'][:1]
             for f in dataclasses.fields(EnvState)}
    acts = data[f'{task}/actions'][:, 0]
    # env 0, then env 0 under each draw, in one batch
    rows = {k: np.repeat(v, N_NUDGES + 1, 0) for k, v in reset.items()}
    for k in range(N_NUDGES):
        rows['pos'][k + 1] = nudged(rows['pos'][k + 1], k)
    st = state_from_numpy(rows, 'cpu')
    sk = state_from_numpy(reset, 'cpu')
    ftab, itab, _ = physics_kernel.table_arrays(sk.max_blocks)
    ftab, itab = torch.from_numpy(ftab), torch.from_numpy(itab)
    bisect = None
    for t, a in enumerate(acts, 1):
        act = torch.full((N_NUDGES + 1,), int(a), dtype=torch.int32)
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
    ref = data[f'{task}/end/pos'][:1]
    end = st.pos.numpy()
    off = np.linalg.norm(end[1:] - end[:1], axis=-1).max(-1)
    return {'env': 0, 'n_steps': len(acts), 'n_nudges': N_NUDGES,
            'plain_vs_reference': dpos_stats(end[:1], ref),
            'host_kernel_vs_reference': dpos_stats(sk.pos.numpy(), ref),
            'host_kernel_vs_plain': dpos_stats(sk.pos.numpy(), end[:1]),
            'draws_vs_plain_at_the_end': dict(
                min=float(off.min()), median=float(np.median(off)),
                max=float(off.max())),
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
    rows = {task: bisect_of(task, data, kernel) for task in tasks}
    # other tasks' entries stay as they are
    out = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            out = json.load(f)
    out.update(rows)
    with open(OUT, 'w') as f:
        json.dump({t: out[t] for t in TASKS if t in out}, f, indent=1)
    for task, row in rows.items():
        print(task, json.dumps(row), flush=True)
    print(f'wrote {OUT}', flush=True)


if __name__ == '__main__':
    main(sys.argv[1:] or TASKS)
