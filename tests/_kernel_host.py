"""The host build of the CUDA kernels' arithmetic, ``kernel_host_shim.cpp``:
the ``__host__ __device__`` code of ``magical_tpu_torch/csrc`` looped over
the batch on the CPU, built with the host C++ compiler and FMA contraction
off, loaded with ctypes.  Imports no JAX, so that the card's tests
(``test_torch_cuda.py``) can hold a kernel's counts against it too."""

import ctypes
import os
import shutil
import subprocess

import torch

from magical_tpu_torch import _build
from magical_tpu_torch.core import render_kernel

HERE = os.path.dirname(os.path.abspath(__file__))


def build(out_dir):
    """The shim built into `out_dir` and loaded, every entry point's
    argument types set; None without a host C++ compiler."""
    cxx = shutil.which('c++') or shutil.which('g++')
    if cxx is None:
        return None
    out = os.path.join(str(out_dir), 'libkernel_host.so')
    subprocess.run(
        [cxx, '-O2', '-std=c++17', '-ffp-contract=off', '-shared', '-fPIC',
         '-I', str(_build.CSRC_DIR), '-o', out,
         os.path.join(HERE, 'kernel_host_shim.cpp')],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    # the host build's physics_control_step takes every block count, with
    # the arguments of the kernel's per-block-count entry points
    sigs = dict(_build.SIGNATURES, physics_control_step=_build.SIGNATURES[
        'physics_control_step_mb1'])
    P = ctypes.c_void_p
    sigs['render_build_display'] = sigs['render_lo_frame'][:-1] + [P] * 5
    sigs['render_prim_bboxes'] = sigs['render_lo_frame'][:-1] + [P] * 2
    sigs['render_set_trig'] = [P] * 3 + [ctypes.c_int]
    sigs['physics_set_lane_order'] = [P]
    sigs['physics_item_tests'] = sigs['physics_control_step'] + [P] * 2
    sigs['physics_narrowphase'] = sigs['physics_control_step'] + [
        ctypes.c_int] + [P] * 4
    sigs['render_hi_class_constants'] = [P]
    sigs['render_hi_probe'] = [P, ctypes.c_int, ctypes.c_int, P,
                               ctypes.c_int, ctypes.c_int, P,
                               ctypes.c_float] + [P] * 5
    for name in ('physics_table_layout', 'physics_control_step',
                 'physics_set_lane_order', 'physics_item_tests',
                 'physics_narrowphase',
                 'render_program_layout', 'render_lo_frame',
                 'render_build_display', 'render_hi_frame',
                 'render_hi_into_slot', 'render_lo_tiles2d',
                 'render_prim_bboxes', 'render_set_trig',
                 'render_hi_class_constants', 'render_hi_probe'):
        fn = getattr(lib, name)
        fn.argtypes = sigs[name]
        fn.restype = ctypes.c_int
    lib.render_trig_misses.restype = ctypes.c_long
    lib.physics_cull_margin.restype = ctypes.c_float
    return lib


def torch_trig(lib, st):
    """Hand the host build PyTorch's cos and sin, on the state's device, of
    every angle that build_prim and the camera take: each body's, and each
    pupil's relative to the robot's.  Returns the CPU tensors, which must
    stay alive while the host reads them."""
    x = torch.cat([st.angle.reshape(-1), st.angle[:, 3] - st.angle[:, 0],
                   st.angle[:, 4] - st.angle[:, 0]]).contiguous()
    x, c, s = (v.cpu().contiguous() for v in (x, torch.cos(x), torch.sin(x)))
    assert lib.render_set_trig(x.data_ptr(), c.data_ptr(), s.data_ptr(),
                               x.numel()) == 0
    return (x, c, s)


def scene_args(st, prog, out, res, view, grid=1):
    """The arguments of the render entry points but the tile (and K4's
    counters) and the stream, for a CPU state, the camera on the grid
    `grid` times finer than `res`: (the tensors to keep alive, the
    arguments)."""
    fields = [getattr(st, name).contiguous()
              for name, _ in render_kernel._SCENE_FIELDS]
    ptrs = [x.data_ptr() for x in fields + [torch.from_numpy(a)
                                            for a in prog] + [out]]
    return fields, ptrs + [st.batch, prog[0].shape[0], res, st.n_bodies,
                           st.max_blocks, st.goal_xyhw.shape[1],
                           *render_kernel.camera_args(view, grid * res)]
