"""The CUDA kernels' own arithmetic, built for the host, against their plain
PyTorch versions.

A CUDA kernel cannot run without the card, but the per-env physics and
per-pixel compositing of ``magical_tpu_torch/csrc`` live in
``__host__ __device__`` functions (``*.cuh``).  ``kernel_host_shim.cpp``
loops them over the batch; it is built here with the host C++ compiler,
with FMA contraction off, and called with the same tables and arguments
the CUDA wrappers pass.  The kernels on the card are held against the same
plain versions by ``chip_smoke.py``.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from magical_tpu_torch import _build
from magical_tpu_torch import constants as C
from magical_tpu_torch.core import physics, physics_kernel, render
from magical_tpu_torch.core import render_kernel
from magical_tpu_torch.tasks import ALL_TASKS

from _torch_port import seek_block_actions

HERE = os.path.dirname(os.path.abspath(__file__))
TASK = ALL_TASKS['MoveToCorner']
SS = TASK.static_block_shapes(TASK.flags_for('Demo'))


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    cxx = shutil.which('c++') or shutil.which('g++')
    if cxx is None:
        pytest.skip('no host C++ compiler to build the kernel sources')
    out = tmp_path_factory.mktemp('kernel_host') / 'libkernel_host.so'
    subprocess.run(
        [cxx, '-O2', '-std=c++17', '-ffp-contract=off', '-shared', '-fPIC',
         '-I', str(_build.CSRC_DIR), '-o', str(out),
         os.path.join(HERE, 'kernel_host_shim.cpp')],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    for name in ('physics_table_layout', 'physics_control_step',
                 'render_lo_frame'):
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def _rollout(B, n_steps, seed):
    """Plain states along a seeded rollout from reset, with the actions
    taken from each: three envs in four drive into the block
    (`seek_block_actions`), the fourth acts at random."""
    st = TASK.reset_fn(torch.Generator().manual_seed(seed), B,
                       TASK.flags_for('Demo'), 'cpu')
    acts = seek_block_actions(B, n_steps)
    rng = np.random.default_rng(seed)
    acts[:, 3::4] = rng.integers(0, 18, acts[:, 3::4].shape)
    out = []
    for i in range(n_steps):
        a = torch.from_numpy(np.ascontiguousarray(acts[i]))
        out.append((st, a))
        st = physics.control_step(st, a)
    return out


def _kernel_step(host_lib, st, a, ftab, itab, phys_steps):
    sk = st.clone()
    physics_kernel.check_inputs(sk, a)
    rc = host_lib.physics_control_step(
        *physics_kernel.kernel_args(sk, a, ftab, itab, phys_steps=phys_steps),
        None)
    assert rc == 0
    return sk


FIELDS = ('vel', 'omega', 'con_jn', 'con_jt', 'joint_acc')
# One substep: the two differ only where the host's sinf/cosf round apart
# from PyTorch's in the last ulp (measured at most 2e-5, on a finger
# velocity); positions integrate from the same inputs and are equal.
SUBSTEP_ATOL = 1e-4
# One control step (10 substeps x 10 sweeps): those ulps grow in the envs
# where the solver is chaotic (the stiff finger pin joints, contacts), but
# the median env stays within 1e-6 in every field (measured <= 6e-7).
STEP_MEDIAN_ATOL = 1e-6


def test_physics_kernel_arithmetic_matches_plain(host_lib):
    ftab, itab, layout = physics_kernel.table_arrays(1)
    got = (ctypes.c_int * 3)()
    host_lib.physics_table_layout(got)
    assert tuple(got) == layout
    ftab, itab = torch.from_numpy(ftab), torch.from_numpy(itab)
    n_contact = 0
    for st, a in _rollout(64, 12, 0):
        sk = _kernel_step(host_lib, st, a, ftab, itab, 1)
        sp = physics.control_step(st, a, phys_steps=1)
        assert torch.equal(sk.pos, sp.pos) and torch.equal(sk.angle, sp.angle)
        for f in FIELDS:
            assert float((getattr(sk, f) - getattr(sp, f)).abs().max()) \
                <= SUBSTEP_ATOL, f
        assert torch.equal(sk.con_id, sp.con_id)

        sk = _kernel_step(host_lib, st, a, ftab, itab, C.PHYS_STEPS)
        sp = physics.control_step(st, a)
        for f in ('pos', 'angle') + FIELDS:
            err = (getattr(sk, f) - getattr(sp, f)).abs() \
                .reshape(st.batch, -1).amax(1)
            assert float(err.median()) <= STEP_MEDIAN_ATOL, f
        assert torch.equal(sk.con_id, sp.con_id)
        assert torch.equal(sk.t, sp.t)
        for f in ('target_speed', 'rel_turn_angle', 'target_finger_angle'):
            assert torch.equal(getattr(sk, f), getattr(sp, f)), f
        n_contact += int((sp.con_id >= 0).any(1).sum())
    assert n_contact > 0


@pytest.mark.parametrize('view', ['allo', 'ego'])
def test_render_kernel_arithmetic_matches_plain(host_lib, view):
    st, _ = _rollout(8, 4, 3)[-1]
    # an active goal as well, for the stippled outline
    st.goal_active[:, 0] = True
    st.goal_xyhw[:, 0] = torch.tensor([-0.4, 0.3, 0.6, 0.5])
    disp = render_kernel.kernel_display(st, 1, 1, True, SS)
    out = torch.empty((st.batch, 96, 96, 3), dtype=torch.uint8)
    ptrs = [disp[k].data_ptr() for k in
            ('verts', 'nv', 'radius', 'color', 'active', 'kind', 'lw')]
    ptrs += [st.pos.data_ptr(), st.angle.data_ptr(), out.data_ptr()]
    rc = host_lib.render_lo_frame(
        *ptrs, st.batch, disp['nv'].shape[1], 96, st.n_bodies,
        *render_kernel.camera_args(view, 96), None)
    assert rc == 0
    plain = render.render_views(st, 1, 1, True, views=(view,),
                                fidelity='lo', static_shapes=SS)[view]
    # same operations in the same order, rounded one by one: byte-equal
    assert torch.equal(out, plain)
    assert np.unique(plain.numpy()).size > 20
