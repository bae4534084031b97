"""One control step on the GPU: the wrapper of ``csrc/physics_step.cu``.

The kernel replaces the Pallas physics kernel of
``magical_tpu/core/physics_pallas.py`` (``pl.pallas_call`` at :1262,
driven by ``control_step_pallas`` :1320), but computes the XLA reference
semantics of ``magical_tpu/core/physics.py``: its plain version is
:func:`magical_tpu_torch.core.physics.control_step`.  One warp per env
runs the whole control step (10 substeps x 10 solver iterations), its
lanes over the env's sub-shape pairs and contacts, the env's state in
shared memory; the source note in the ``.cu`` file says what bounds it.

The TPU's ``pack_state``/``tile_for``/``_pad_batch`` machinery has no
counterpart: the kernel reads the state tensors in place and masks the
ragged edge itself, so any batch size works.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from magical_tpu_torch import _build, trace
from magical_tpu_torch import constants as C
from magical_tpu_torch import geometry as G
from magical_tpu_torch.core import physics
from magical_tpu_torch.core.state import (EnvState, max_contacts,
                                          n_joint_acc)

# Block counts the kernel is instantiated for (csrc/physics_step.cu and
# csrc/physics_step_mb<MB>.cu): those of the eight task families.
SUPPORTED_MAX_BLOCKS = (1, 3, 4, 7, 8, 10)
# Offsets the C side reports through physics_table_layout.
_N_SCALARS = 7
# The phases whose cycles the kernel counts (csrc/physics_step.cuh PH_*).
PHASES = ('narrowphase', 'prestep', 'sweep', 'apply', 'joints', 'other')
# What the kernel counts of its narrowphase's items, summed over substeps:
# the items of active slots, and those the cull left for the full test.
ITEMS = ('candidates', 'tested')

_TABLES = {}


def slot_bounds(verts, nv, radius):
    """Each slot's bounding circle in its body's frame, (..., 3) float32:
    the mean of its `nv` vertices, and the largest distance from there to
    any of its vertices plus its `radius` (the kernel's cull, Poly::bound;
    its margin covers the rounding)."""
    verts = np.asarray(verts, np.float64)
    nv = np.asarray(nv)
    real = np.arange(verts.shape[-2]) < nv[..., None]
    centre = (verts * real[..., None]).sum(-2) / nv[..., None]
    reach = np.linalg.norm(verts - centre[..., None, :], axis=-1).max(-1)
    return np.concatenate([centre, (reach + radius)[..., None]],
                          -1).astype(np.float32)


def table_arrays(max_blocks: int):
    """The kernel's static float and int tables, as numpy, in the layout
    of csrc/physics_step.cuh (FT_* / IT_* offsets)."""
    rverts, rnv, rrad = physics.robot_slot_geometry()
    inv_m_robot = np.array([
        1.0 / C.ROBOT_MASS,
        1.0 / C.FINGER_MASS, 1.0 / C.FINGER_MASS,
        1.0 / C.EYE_MASS, 1.0 / C.EYE_MASS], dtype=np.float32)
    inv_i_robot = np.array([
        1.0 / G.ROBOT_GEOM['body_moment'],
        1.0 / G.ROBOT_GEOM['finger_moment'],
        1.0 / G.ROBOT_GEOM['finger_moment'],
        1.0 / G.ROBOT_GEOM['eye_moment'],
        1.0 / G.ROBOT_GEOM['eye_moment']], dtype=np.float32)
    scalars = np.array([
        C.DT, physics.CONTACT_BIAS_COEF, C.COLLISION_SLOP,
        C.ROBOT_GEAR_MAX_BIAS, C.EYE_SPRING_STIFFNESS,
        -C.EYE_SPRING_DAMPING * C.DT, C.SHAPE_MASS], dtype=np.float32)
    assert len(scalars) == _N_SCALARS
    slot_body, _ = physics.slot_tables(max_blocks)
    pair_a, pair_b = physics.pair_table(max_blocks)
    cand_a, cand_b, cand_fr = physics.candidate_bodies(max_blocks)
    f_parts = [C.ACTION_TARGET_SPEED, C.ACTION_TURN_ANGLE,
               C.ACTION_FINGER_ANGLE, G.BLOCK_VERTS, G.BLOCK_SUB_RADIUS,
               G.BLOCK_MOMENT, rverts, rrad, inv_m_robot, inv_i_robot,
               G.ROBOT_GEOM['finger_rel_pos'],
               G.ROBOT_GEOM['finger_rot_limits'],
               slot_bounds(G.BLOCK_VERTS, G.BLOCK_SUB_NV,
                           G.BLOCK_SUB_RADIUS),
               slot_bounds(rverts, rnv, rrad)]
    cand_friction_at = sum(np.asarray(p).size for p in f_parts) \
        + len(scalars)
    ftab = np.concatenate([np.asarray(p, np.float32).reshape(-1)
                           for p in f_parts + [scalars, cand_fr]])
    i_parts = [G.BLOCK_SUB_NV, G.BLOCK_SUB_ACTIVE, rnv]
    slot_body_at = sum(np.asarray(p).size for p in i_parts)
    itab = np.concatenate([np.asarray(p, np.int32).reshape(-1)
                           for p in i_parts + [slot_body, pair_a, pair_b,
                                               cand_a, cand_b]])
    return ftab, itab, (cand_friction_at, _N_SCALARS, slot_body_at)


def _tables(max_blocks: int, device):
    key = (max_blocks, str(device))
    if key not in _TABLES:
        ftab, itab, layout = table_arrays(max_blocks)
        out = (ctypes.c_int * 3)()
        _build.library().physics_table_layout(out)
        if tuple(out) != layout:
            raise RuntimeError(f'physics table layout mismatch: kernel '
                               f'{tuple(out)}, python {layout}')
        _TABLES[key] = (torch.from_numpy(ftab).to(device),
                        torch.from_numpy(itab).to(device))
    return _TABLES[key]


# (field, dtype, per-env shape) of every state tensor the kernel touches
def _fields(mb: int):
    nb = 5 + mb
    maxc = max_contacts(mb)
    f, i = torch.float32, torch.int32
    return [('pos', f, (nb, 2)), ('angle', f, (nb,)), ('vel', f, (nb, 2)),
            ('omega', f, (nb,)), ('v_bias', f, (nb, 2)),
            ('w_bias', f, (nb,)), ('target_speed', f, ()),
            ('rel_turn_angle', f, ()), ('target_finger_angle', f, ()),
            ('block_shape', i, (mb,)), ('block_active', torch.bool, (mb,)),
            ('phys', f, (C.N_PHYS_VARS,)), ('con_id', i, (maxc,)),
            ('con_jn', f, (maxc,)), ('con_jt', f, (maxc,)),
            ('joint_acc', f, (n_joint_acc(mb),)), ('t', i, ())]


def check_inputs(state: EnvState, action: torch.Tensor):
    """Raise unless every tensor is what the kernel takes: on the state's
    CUDA device, of the expected dtype and shape, contiguous."""
    mb = state.max_blocks
    if mb not in SUPPORTED_MAX_BLOCKS:
        raise ValueError(f'physics kernel is built for max_blocks in '
                         f'{SUPPORTED_MAX_BLOCKS}, not {mb}')
    B = state.batch
    dev = state.device
    tensors = [(name, getattr(state, name), dt, shp)
               for name, dt, shp in _fields(mb)]
    tensors.append(('action', action, torch.int32, ()))
    for name, x, dt, shp in tensors:
        if x.device != dev:
            raise ValueError(f'{name} is on {x.device}, state on {dev}')
        if x.dtype != dt:
            raise TypeError(f'{name} has dtype {x.dtype}, kernel takes {dt}')
        if tuple(x.shape) != (B,) + shp:
            raise ValueError(f'{name} has shape {tuple(x.shape)}, kernel '
                             f'takes {(B,) + shp}')
        if not x.is_contiguous():
            raise ValueError(f'{name} is not contiguous')


def kernel_args(state: EnvState, action: torch.Tensor, ftab, itab,
                phys_steps: int = C.PHYS_STEPS,
                iterations: int = C.PHYS_ITER, phase_clock=None,
                item_count=None):
    """The C entry point's arguments for this state (pointers as ints),
    but the stream."""
    ptrs = [getattr(state, name).data_ptr()
            for name, _, _ in _fields(state.max_blocks)]
    return ptrs + [action.data_ptr(), ftab.data_ptr(), itab.data_ptr(),
                   state.batch, state.max_blocks, phys_steps, iterations] + [
        None if x is None else x.data_ptr() for x in (phase_clock,
                                                      item_count)]


def check_counter(name, x, state, width):
    """Raise unless `x` is None or a contiguous int64 (B, `width`) tensor
    on the state's device: a kernel's counter."""
    if x is not None and (x.device != state.device
                          or x.dtype != torch.int64
                          or tuple(x.shape) != (state.batch, width)
                          or not x.is_contiguous()):
        raise ValueError(f'{name} must be a contiguous int64 '
                         f'{(state.batch, width)} tensor on {state.device}')


def control_step(state: EnvState, action: torch.Tensor,
                 phase_clock=None, item_count=None) -> EnvState:
    """One control step for every env.

    On a CUDA state this launches the kernel, which updates the state's
    tensors IN PLACE (the returned state is the argument); `action` must
    be an int32 (B,) tensor on the same device.  `phase_clock`, an int64
    (B, len(PHASES)) CUDA tensor, gets each env's clock64() cycles in each
    phase of :data:`PHASES` added to it; `item_count`, an int64 (B,
    len(ITEMS)) one, each env's narrowphase items of :data:`ITEMS`.  On a
    CPU state it runs the plain version, :func:`core.physics.control_step`,
    which returns a new state.  Both run in one ``magical.k1`` span
    (:mod:`trace`)."""
    with trace.span('magical.k1'):
        if state.device.type == 'cpu' and action.device.type == 'cpu':
            return physics.control_step(state, action)
        if state.device.type != 'cuda':
            raise ValueError(f'physics kernel needs a CUDA state, got '
                             f'{state.device}')
        check_inputs(state, action)
        check_counter('phase_clock', phase_clock, state, len(PHASES))
        check_counter('item_count', item_count, state, len(ITEMS))
        ftab, itab = _tables(state.max_blocks, state.device)
        stream = torch.cuda.current_stream(state.device).cuda_stream
        entry = f'physics_control_step_mb{state.max_blocks}'
        rc = getattr(_build.library(), entry)(
            *kernel_args(state, action, ftab, itab, phase_clock=phase_clock,
                         item_count=item_count),
            stream)
        _build.check(rc, entry)
        control_step.launches += 1
        return state


control_step.launches = 0
