"""One control step on the GPU: the wrapper of ``csrc/physics_step.cu``.

The kernel replaces the Pallas physics kernel of
``magical_tpu/core/physics_pallas.py`` (``pl.pallas_call`` at :1262,
driven by ``control_step_pallas`` :1320), but computes the XLA reference
semantics of ``magical_tpu/core/physics.py``: its plain version is
:func:`magical_tpu_torch.core.physics.control_step`.  One thread per env
runs the whole control step (10 substeps x 10 solver iterations) with the
env's bodies and contacts in registers and local memory; the source note
in the ``.cu`` file says what bounds it.

The TPU's ``pack_state``/``tile_for``/``_pad_batch`` machinery has no
counterpart: the kernel reads the state tensors in place and masks the
ragged edge itself, so any batch size works.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from magical_tpu_torch import _build
from magical_tpu_torch import constants as C
from magical_tpu_torch import geometry as G
from magical_tpu_torch.core import physics
from magical_tpu_torch.core.state import (EnvState, max_contacts,
                                          n_joint_acc)

# Block counts the kernel is instantiated for (csrc/physics_step.cu).
SUPPORTED_MAX_BLOCKS = (1,)
# Offsets the C side reports through physics_table_layout.
_N_SCALARS = 7

_TABLES = {}


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
               G.ROBOT_GEOM['finger_rot_limits']]
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
        raise NotImplementedError(
            f'physics kernel is built for max_blocks in '
            f'{SUPPORTED_MAX_BLOCKS}, not {mb} (ROADMAP.md, "Modules to '
            f'port", item 2)')
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
                iterations: int = C.PHYS_ITER):
    """The C entry point's arguments for this state (pointers as ints)."""
    ptrs = [getattr(state, name).data_ptr()
            for name, _, _ in _fields(state.max_blocks)]
    return ptrs + [action.data_ptr(), ftab.data_ptr(), itab.data_ptr(),
                   state.batch, state.max_blocks, phys_steps, iterations]


def control_step(state: EnvState, action: torch.Tensor) -> EnvState:
    """One control step for every env.

    On a CUDA state this launches the kernel, which updates the state's
    tensors IN PLACE (the returned state is the argument); `action` must
    be an int32 (B,) tensor on the same device.  On a CPU state it runs
    the plain version, :func:`core.physics.control_step`, which returns a
    new state."""
    if state.device.type == 'cpu' and action.device.type == 'cpu':
        return physics.control_step(state, action)
    if state.device.type != 'cuda':
        raise ValueError(f'physics kernel needs a CUDA state, got '
                         f'{state.device}')
    check_inputs(state, action)
    ftab, itab = _tables(state.max_blocks, state.device)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = _build.library().physics_control_step(
        *kernel_args(state, action, ftab, itab), stream)
    _build.check(rc, 'physics_control_step')
    control_step.launches += 1
    return state


control_step.launches = 0
