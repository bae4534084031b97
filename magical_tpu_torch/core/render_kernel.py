"""Lo-fidelity frames on the GPU: the wrappers of ``csrc/render_lo.cu``.

One CUDA kernel, two entry points:

  * :func:`render_into_slots` — K2, the render of every step, written
    straight into slot ``t mod depth`` of each view's frame ring; it
    replaces ``render_into_slots_pallas``
    (``magical_tpu/core/render_pallas.py:815``, ``pl.pallas_call`` :918);
  * :func:`render_views_lo` — K3, fresh frames (the reset frame); it
    replaces the lo branch of ``render_batch_pallas`` (:608,
    ``pl.pallas_call`` :766).

Both composite what ``core/render.py`` renders at lo fidelity
(``render_frame(aa=True)`` + ``to_uint8``), which is their plain version.
The display list is built by the plain, batched ``build_display_list``
(as the JAX package builds it in XLA); the kernel takes per-slot kinds and
line widths from ``static_prim_meta`` and computes the camera itself.
"""

from __future__ import annotations

import numpy as np
import torch

from magical_tpu_torch import _build
from magical_tpu_torch import constants as C
from magical_tpu_torch.core import preproc, render
from magical_tpu_torch.core.state import EnvState

MAX_PRIMS = 64          # csrc/render_lo.cu MAX_PRIMS
MAX_BATCH = 65535       # grid.y


def camera_args(view: str, res: int):
    """(ego, scale, half, newpos_x, newpos_y, lw_scale, 2*scale, bg r, g,
    b) for the C entry points; floats are rounded to f32 by ctypes as the
    plain version rounds them."""
    if view == 'allo':
        scale = res / (2 * C.ARENA_ZOOM_OUT)
        ego, npx, npy = 0, 0.0, 0.0
    elif view == 'ego':
        world_w = 2.0 * C.ARENA_ZOOM_OUT
        scale = res / world_w
        ego = 1
        npx, npy = (float(x) for x in np.asarray(
            [world_w * 0.5, world_w * 0.15], np.float32))
    else:
        raise ValueError(f'unknown view {view!r}')
    bg = [float(x) for x in C.BACKGROUND_COLOUR]
    return [ego, scale, C.ARENA_ZOOM_OUT, npx, npy, res / 384.0,
            2.0 * scale, *bg]


def kernel_display(state: EnvState, max_blocks: int, max_goals: int,
                   robot_first: bool, static_shapes=None):
    """The batched display list and static per-slot kinds / line widths,
    as the contiguous tensors the kernel reads."""
    d = render.build_display_list(state, max_blocks, max_goals, robot_first,
                                  static_shapes=static_shapes)
    meta = render.static_prim_meta(max_blocks, max_goals, robot_first,
                                   static_shapes)
    dev = state.device
    return dict(
        verts=d['verts'].contiguous(), nv=d['nv'].contiguous(),
        radius=d['radius'].contiguous(), color=d['color'].contiguous(),
        active=d['active'].contiguous(),
        kind=torch.tensor([m[0] for m in meta], dtype=torch.int32,
                          device=dev),
        lw=torch.tensor([m[1] for m in meta], dtype=torch.float32,
                        device=dev))


def _check(disp, state: EnvState, out: torch.Tensor, res: int):
    B = state.batch
    P = disp['nv'].shape[1]
    if P > MAX_PRIMS:
        raise ValueError(f'{P} display prims; the kernel takes {MAX_PRIMS}')
    if B > MAX_BATCH:
        raise ValueError(f'batch {B}; the kernel takes {MAX_BATCH}')
    want = [('verts', torch.float32, (B, P, render.NV, 2)),
            ('nv', torch.int32, (B, P)), ('radius', torch.float32, (B, P)),
            ('color', torch.float32, (B, P, 3)),
            ('active', torch.bool, (B, P)), ('kind', torch.int32, (P,)),
            ('lw', torch.float32, (P,))]
    items = [(k, disp[k], dt, shp) for k, dt, shp in want]
    nb = state.n_bodies
    items += [('pos', state.pos, torch.float32, (B, nb, 2)),
              ('angle', state.angle, torch.float32, (B, nb)),
              ('out', out, torch.uint8, (B, res, res, 3))]
    for name, x, dt, shp in items:
        if x.device != state.device or x.device.type != 'cuda':
            raise ValueError(f'{name} is on {x.device}; the kernel takes '
                             f'CUDA tensors on {state.device}')
        if x.dtype != dt:
            raise TypeError(f'{name} has dtype {x.dtype}, kernel takes {dt}')
        if tuple(x.shape) != shp:
            raise ValueError(f'{name} has shape {tuple(x.shape)}, kernel '
                             f'takes {shp}')
        if not x.is_contiguous():
            raise ValueError(f'{name} is not contiguous')


def _launch(entry: str, disp, state: EnvState, out: torch.Tensor,
            view: str, res: int):
    _check(disp, state, out, res)
    ptrs = [disp[k].data_ptr() for k in
            ('verts', 'nv', 'radius', 'color', 'active', 'kind', 'lw')]
    ptrs += [state.pos.data_ptr(), state.angle.data_ptr(), out.data_ptr()]
    ints = [state.batch, disp['nv'].shape[1], res, state.n_bodies]
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = getattr(_build.library(), entry)(
        *ptrs, *ints, *camera_args(view, res), stream)
    _build.check(rc, entry)


def render_views_lo(state: EnvState, max_blocks: int, max_goals: int,
                    robot_first: bool, res: int = 96,
                    views=('allo', 'ego'), static_shapes=None):
    """Fresh lo-fidelity frames {view: (B, res, res, 3) uint8} (K3).

    On a CUDA state it launches the kernel once per view; on a CPU state
    it is the plain ``render.render_views(..., fidelity='lo')``."""
    if state.device.type == 'cpu':
        return render.render_views(state, max_blocks, max_goals,
                                   robot_first, res=res, views=views,
                                   fidelity='lo', static_shapes=static_shapes)
    disp = kernel_display(state, max_blocks, max_goals, robot_first,
                          static_shapes)
    out = {}
    for view in views:
        frame = torch.empty((state.batch, res, res, 3), dtype=torch.uint8,
                            device=state.device)
        _launch('render_lo_frame', disp, state, frame, view, res)
        render_views_lo.launches += 1
        out[view] = frame
    return out


render_views_lo.launches = 0


def render_into_slots(state: EnvState, rings: dict, t: int, max_blocks: int,
                      max_goals: int, robot_first: bool, spec, res: int = 96,
                      static_shapes=None):
    """Render the step-`t` lo frame of every view of `spec` into slot
    ``t mod depth`` of its ring (``rings[view]``: (depth, B, res, res, 3)
    uint8), IN PLACE (K2); returns `rings`.

    On a CUDA state it launches the kernel once per view, writing the
    ring slot directly; on a CPU state it renders with the plain
    ``render.render_views`` and copies the frames in."""
    if state.device.type == 'cpu':
        return preproc.push_frames_cf(spec, rings, render.render_views(
            state, max_blocks, max_goals, robot_first, res=res,
            views=spec.views, fidelity='lo', static_shapes=static_shapes), t)
    disp = kernel_display(state, max_blocks, max_goals, robot_first,
                          static_shapes)
    for view in spec.views:
        ring = rings[view]
        depth = spec.depth(view)
        if ring.dim() != 5 or ring.shape[0] != depth:
            raise ValueError(f'{view} ring has shape {tuple(ring.shape)}, '
                             f'want ({depth}, B, {res}, {res}, 3)')
        _launch('render_lo_into_slot', disp, state, ring[t % depth], view,
                res)
        render_into_slots.launches += 1
    return rings


render_into_slots.launches = 0
