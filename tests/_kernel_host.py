"""The host build of the CUDA kernels' arithmetic, ``kernel_host_shim.cpp``
(and the placement's, ``place_host_shim.cpp``, a library of its own):
the ``__host__ __device__`` code of ``magical_tpu_torch/csrc`` looped over
the batch on the CPU, built with the host C++ compiler and FMA contraction
off, loaded with ctypes.  Imports no JAX, so that the card's tests
(``test_torch_cuda.py``) can hold a kernel's counts against it too."""

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np
import torch

from magical_tpu_torch import _build
from magical_tpu_torch import geometry
from magical_tpu_torch.core import collision, render_kernel
from magical_tpu_torch.tasks import randomize

HERE = os.path.dirname(os.path.abspath(__file__))


def _compile(out_dir, source, name, defines=()):
    """`source` (a file beside this one) built with the host C++ compiler
    into `out_dir` as lib`name`.so, with the preprocessor `defines` (each
    ``NAME=value``), and loaded; None without a compiler."""
    cxx = shutil.which('c++') or shutil.which('g++')
    if cxx is None:
        return None
    out = os.path.join(str(out_dir), f'lib{name}.so')
    subprocess.run(
        [cxx, '-O2', '-std=c++17', '-ffp-contract=off', '-shared', '-fPIC',
         '-I', str(_build.CSRC_DIR), *(f'-D{d}' for d in defines), '-o', out,
         os.path.join(HERE, source)],
        check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(out)


def build(out_dir):
    """The shim built into `out_dir` and loaded, every entry point's
    argument types set; None without a host C++ compiler."""
    lib = _compile(out_dir, 'kernel_host_shim.cpp', 'kernel_host')
    if lib is None:
        return None
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


def build_place(out_dir, defines=()):
    """The placement's shim (``place_host_shim.cpp``, place.cuh alone)
    built into `out_dir` with the preprocessor `defines` and loaded, its
    entry points' argument types set; None without a host C++ compiler."""
    lib = _compile(out_dir, 'place_host_shim.cpp', 'place_host', defines)
    if lib is None:
        return None
    P = ctypes.c_void_p
    first_fit = _build.SIGNATURES['place_first_fit']
    for name, sig in (('place_first_fit', first_fit),
                      ('place_fits', first_fit[:-1] + [P]),
                      ('place_add_sqrt', [P, P, ctypes.c_int])):
        fn = getattr(lib, name)
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    lib.place_sqrt_misses.argtypes = [P, ctypes.c_long]
    lib.place_sqrt_misses.restype = ctypes.c_long
    return lib


def place_args(props_pos, props_ang, ent_geom, placed, placed_mask):
    """The placement entry points' arguments but the outputs, for CPU
    tensors, the cosines and sines of the proposals' angles computed as the
    plain version computes them (randomize.transform_entity): (the tensors
    to keep alive, the pointers, (B, T, E))."""
    B, T = props_ang.shape
    ang = props_ang[..., None].expand(B, T, randomize.KSUB)
    x = [props_pos, torch.cos(ang)[..., 0], torch.sin(ang)[..., 0],
         *ent_geom, *placed, placed_mask]
    x = [t.contiguous() for t in x]
    return x, [t.data_ptr() for t in x], (B, T, placed_mask.shape[1])


def _with_torch_sqrt(lib, run):
    """`run()` (a placement entry point's call) until it takes PyTorch's
    CPU sqrt of every input: after each call, the inputs whose roots were
    not handed in are, and it runs again."""
    for _ in range(8):
        assert run() == 0
        missed = torch.empty(1 << 16)
        n = lib.place_sqrt_misses(missed.data_ptr(), missed.numel())
        if n == 0:
            return
        if n > missed.numel():
            missed = torch.empty(n)
            lib.place_sqrt_misses(missed.data_ptr(), n)
        x = missed[:n].contiguous()
        y = torch.sqrt(x)
        assert lib.place_add_sqrt(x.data_ptr(), y.data_ptr(), n) == 0
    raise AssertionError('the placement kept taking new square roots')


def place_first_fit(lib, *args, counts=None):
    """The host build's placement, PyTorch's CPU sqrt its square root:
    (pick (B,) int64, ok (B,) bool); `counts`, where given, added to."""
    keep, ptrs, (B, T, E) = place_args(*args)
    pick = torch.empty(B, dtype=torch.int64)
    ok = torch.empty(B, dtype=torch.bool)
    start = None if counts is None else counts.clone()

    def run():
        if counts is not None:
            counts.copy_(start)
        return lib.place_first_fit(
            *ptrs, pick.data_ptr(), ok.data_ptr(),
            None if counts is None else counts.data_ptr(), B, T, E, None)
    _with_torch_sqrt(lib, run)
    return pick, ok


def place_fits(lib, *args):
    """The host build's test of every proposal, PyTorch's CPU sqrt its
    square root: (B, T) bool."""
    keep, ptrs, (B, T, E) = place_args(*args)
    fits = torch.empty((B, T), dtype=torch.int32)
    _with_torch_sqrt(lib, lambda: lib.place_fits(
        *ptrs, None, None, None, B, T, E, fits.data_ptr()))
    return fits.bool()


# ---------------------------------------------------------------------------
# The placement's adversarial sweep: proposals within ulps of contact
# ---------------------------------------------------------------------------

def entity_kinds():
    """Every entity a reset places, as (name, local geometry (1, ...)):
    the robot, each block shape and a goal region."""
    kinds = [('robot', tuple(torch.as_tensor(x)[None]
                             for x in randomize.robot_placement_geom()))]
    for s in range(geometry.N_SHAPE_TYPES):
        kinds.append((f'block{s}', randomize.block_placement_geom(
            torch.tensor([s], dtype=torch.int32))))
    kinds.append(('goal', randomize.goal_placement_geom(
        torch.tensor([0.3]), torch.tensor([0.45]))))
    return kinds


N_DIRS = 12
N_ULPS = 32
STEP = 2.0 ** -25      # a step along the line: an ulp or less of a coordinate


def _rows(geom, n):
    return tuple(x.expand((n,) + x.shape[1:]) for x in geom)


def _near_contact(plain, c0, d):
    """For each case, the distance s along unit direction `d` (n, 2) from
    `c0` (n, 2) at which `plain(pos (n, 1, 2))` (n, 1) bool turns from False
    to True, bisected in float64 over [0, 0.9]; then the T = 2 N_ULPS
    proposals within N_ULPS steps of it, (n, T, 2) float32."""
    def at(s):
        return torch.from_numpy((c0 + s[:, None] * d).astype(np.float32))
    lo, hi = np.zeros(len(c0)), np.full(len(c0), 0.9)
    assert not plain(at(lo)[:, None]).any() and plain(at(hi)[:, None]).all()
    for _ in range(40):
        mid = (lo + hi) / 2
        up = plain(at(mid)[:, None])[:, 0].numpy()
        lo, hi = np.where(up, lo, mid), np.where(up, mid, hi)
    k = np.arange(-N_ULPS, N_ULPS) * STEP
    pos = c0[:, None] + (hi[:, None, None] + k[None, :, None]) * d[:, None]
    return torch.from_numpy(pos.astype(np.float32))


@functools.lru_cache(maxsize=None)
def placement_cases():
    """Every pair of entity kinds (the proposal's, then the placed one's),
    at N_DIRS directions and body angles, and every kind against each
    wall, with the proposals within a few ulps either side of contact: as
    (case, the placement's arguments, the plain version's fits (n, T))."""
    kinds = entity_kinds()
    j = np.arange(N_DIRS)
    phi = 2 * np.pi * j / N_DIRS + 0.05
    d = np.stack([np.cos(phi), np.sin(phi)], -1)
    th_a = torch.tensor(2 * np.pi * (5 * j % N_DIRS) / N_DIRS + 0.3,
                        dtype=torch.float32)
    th_b = torch.tensor(2 * np.pi * (7 * j % N_DIRS) / N_DIRS - 0.1,
                        dtype=torch.float32)
    out = []
    for na, ga in kinds:
        ent = _rows(ga, N_DIRS)
        cases = [((na, nb), _rows(gb, N_DIRS)) for nb, gb in kinds]
        cases += [((na, f'wall{w}'), None) for w in range(4)]
        for case, gb in cases:
            if gb is None:
                # from beside the wall (every kind reaches past it from
                # 0.95) back towards the centre, at offsets along it
                dw = -collision.WALL_NORMALS[int(case[1][4:])].astype(float)
                c0 = 0.95 * dw + 0.3 * np.abs(dw[::-1]) * d[:, 1:]
                dd = np.broadcast_to(-dw, d.shape)
                placed = tuple(x[:, :0] for x in randomize.transform_entity(
                    tuple(x[:, None] for x in ent),
                    torch.zeros(N_DIRS, 1, 2), torch.zeros(N_DIRS, 1)))
                mask = torch.zeros((N_DIRS, 0), dtype=torch.bool)
            else:
                # the placed entity 0.4 from the centre, the proposal moving
                # away from it through the centre (the robot reaches 0.405)
                c0, dd = -0.4 * d, d
                placed = randomize.transform_entity(
                    tuple(x[:, None] for x in gb),
                    torch.from_numpy(c0.astype(np.float32))[:, None],
                    th_b[:, None])
                mask = torch.ones((N_DIRS, 1), dtype=torch.bool)

            def args_at(pos, placed=placed, mask=mask):
                return (pos, th_a[:, None].expand(pos.shape[:2]), ent,
                        placed, mask)
            pos = _near_contact(
                lambda p: randomize.proposal_fits(*args_at(p)), c0, dd)
            out.append((case, args_at(pos),
                        randomize.proposal_fits(*args_at(pos))))
    return out
