"""Frames on the GPU: the wrappers of ``csrc/render_lo.cu`` and
``csrc/render_hi.cu``.

The CUDA kernels and their entry points:

  * :func:`render_into_slots` — K2, the lo render of every step, written
    straight into slot ``t mod depth`` of each view's frame ring; it
    replaces ``render_into_slots_pallas``
    (``magical_tpu/core/render_pallas.py:815``, ``pl.pallas_call`` :918);
  * :func:`render_views_lo` — K3, fresh lo frames (the reset frame); it
    replaces the lo branch of ``render_batch_pallas`` (:608,
    ``pl.pallas_call`` :766);
  * :func:`render_views_hi` and :func:`render_hi_into_slots` — K4, hi
    fidelity, fresh frames and ring slots; they replace the hi branch of
    ``render_batch_pallas``, ``_render_kernel_hi`` (:517, ``pl.pallas_call``
    :766);
  * :func:`render_lo_tiles2d` — K5, fresh lo frames over the caller's 2-D
    pixel tiles, reached through ``render_views_lo(tiles2d=(row_tile,
    col_tile))``; it replaces ``render_batch_pallas(tiles2d=...)``,
    ``_render_kernel_2d`` (:474, ``pl.pallas_call`` :692).

Their plain version is ``core/render.py``'s ``render_views`` at the same
fidelity: ``render_frame(aa=True)`` + ``to_uint8`` at lo, and hard
coverage at 4x, ``to_uint8`` and ``downsample4`` at hi.  Every kernel
takes the state itself: each block builds its env's display list in
shared memory from the state's tensors and the scene's display program
(:func:`display_program`, made once per scene and device), keeps the
prims whose screen box (:func:`prim_screen_bboxes`) meets its tile of
pixels (at hi, of subpixels of the 4x grid) and composites its pixels
over them, so a render builds nothing on the host and copies nothing
from it.  The cull is exact: every tiling gives the same bytes.  Every
kernel computes the camera itself.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from magical_tpu_torch import _build, trace
from magical_tpu_torch import constants as C
from magical_tpu_torch import geometry as G
from magical_tpu_torch.core import collision, preproc, render
from magical_tpu_torch.core.state import EnvState

MAX_PRIMS = 240         # MAX_PRIMS of csrc/render_lo.cuh


def camera_args(view: str, res: int):
    """(ego, scale, half, newpos_x, newpos_y, lw_scale, 2*scale, bg r, g,
    b) of the camera grid at `res` (4x the output's at hi fidelity) for
    the C entry points; floats are rounded to f32 by ctypes as the plain
    version rounds them."""
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


# The display program's layout (csrc/render_lo.cuh PI_* / PF_* / OP_* and
# the TF_* / TI_* tables), checked against render_program_layout.
PROG_I = 8                    # op, idx, table, k, shape, nv, colour table, kind
PROG_F = 2 * render.NV + 5    # local verts, radius, line width, colour
OPS = ('static', 'goal', 'body_poly', 'body_circle', 'eye', 'pupil',
       'block')
# The output pixels a block of K2/K3 (LO_TILE) and of K4 (HI_TILE) renders,
# as (rows, cols): the fastest tilings measured (PERF.md).
LO_TILE = (32, 32)
HI_TILE = (32, 32)
# What K4's step launch counts for each env, summed over its blocks, where
# its caller passes the counters (csrc/render_tiles.cuh HiCounts): clock64()
# cycles building and culling the prims, and shading the tile (classing
# its pixels included); the active prims from slot 2 up (slots 0 and 1, the
# arena's fill and border, are kept by every block), and those whose box
# meets the tile's subpixels; the tile's pixels, and those a prim's edge
# leaves undecided by their centre's classes, shaded per subpixel.
K4_PHASES = ('build', 'shade')
K4_ITEMS = ('active', 'kept')
K4_PIXELS = ('pixels', 'undecided')
# K4's counters (trace.KernelCounters), in the order of its entry point's
# pointers.
K4_COUNTERS = ('k4_cycles', 'k4_items', 'k4_pixels')
trace.declare('k4_cycles', K4_PHASES)
trace.declare('k4_items', K4_ITEMS)
trace.declare('k4_pixels', K4_PIXELS)

_PROGRAMS = {}


def program_arrays(max_blocks: int, max_goals: int, robot_first: bool,
                   static_shapes=None):
    """The display program of a scene, as numpy: per slot of
    :func:`render.display_slots` one row of `prog_i` (P, PROG_I) int32 and
    `prog_f` (P, PROG_F) float32, and the shared tables `tab_f` (block
    sub-shape vertices and radii, outer then inner, and the colour tables
    goal light, block, block dark) and `tab_i` (sub-shape vertex counts,
    then whether each sub-shape exists, outer then inner).  Constants are
    rounded to float32 from the same Python values `build_display_list`
    rounds."""
    slots = render.display_slots(max_blocks, max_goals, robot_first,
                                 static_shapes)
    meta = render.static_prim_meta(max_blocks, max_goals, robot_first,
                                   static_shapes)
    arena_fill, robot = render._static_prims()
    f32 = np.float32
    P = len(slots)
    prog_i = np.zeros((P, PROG_I), np.int32)
    prog_f = np.zeros((P, PROG_F), np.float32)
    rr = C.ROBOT_RAD
    for i, (src, (kind, lw, nv, _, _)) in enumerate(zip(slots, meta)):
        verts, colour, rad, coltab, idx, table, k, shape = (
            None, None, 0.0, -1, 0, 0, 0, -1)
        if src[0] == 'arena':
            op, verts = 'static', arena_fill
            colour = [1.0, 1.0, 1.0] if src[1] == 'fill' else C.ARENA_GREY
        elif src[0] == 'goal':
            op, idx, coltab = 'goal', src[1], 0 if src[2] == 'fill' else 1
        elif src[0] == 'finger':
            _, side, (verts, _), colour = robot[src[1]]
            op, idx = 'body_poly', 1 + side
        elif src[0] == 'body':
            op, colour = 'body_circle', (C.ROBOT_COLOUR_DARK if src[1] ==
                                         'outer' else C.ROBOT_COLOUR)
            rad = rr if src[1] == 'outer' else rr - C.ROBOT_LINE_THICKNESS
        elif src[0] in ('eye', 'pupil'):
            op, idx = src
            x_sign = (-1.0, 1.0)[idx]
            verts = np.zeros((render.NV, 2), np.float32)
            verts[0] = [x_sign * 0.4 * rr, 0.3 * rr]          # eye centre
            verts[1] = [0.0, 0.07 * rr]                       # pupil offset
            rad, colour = ((0.2 * rr, [1.0, 1.0, 1.0]) if op == 'eye'
                           else (0.12 * rr, [0.1, 0.1, 0.1]))
        else:
            _, idx, table, k, sc = src
            op, coltab = 'block', 2 if table == 0 else 1
            shape = -1 if sc is None else sc
        prog_i[i] = [OPS.index(op), idx, table, k, shape,
                     -1 if nv is None else nv, coltab, kind]
        if verts is not None:
            prog_f[i, :2 * render.NV] = np.asarray(verts, f32).reshape(-1)
        prog_f[i, 2 * render.NV] = f32(rad)
        prog_f[i, 2 * render.NV + 1] = f32(lw)
        if colour is not None:
            prog_f[i, 2 * render.NV + 2:] = np.asarray(colour, f32)
    tab_f = np.concatenate([np.asarray(x, f32).reshape(-1) for x in (
        G.BLOCK_VERTS, G.BLOCK_VERTS_INNER, G.BLOCK_SUB_RADIUS,
        G.BLOCK_SUB_RADIUS_INNER, C.GOAL_COLOURS_LIGHT, C.BLOCK_COLOURS,
        C.BLOCK_COLOURS_DARK)])
    tab_i = np.concatenate([np.asarray(x, np.int32).reshape(-1) for x in (
        G.BLOCK_SUB_NV, G.BLOCK_SUB_NV_INNER, G.BLOCK_SUB_ACTIVE,
        G.BLOCK_SUB_ACTIVE_INNER)])
    return prog_i, prog_f, tab_f, tab_i


def display_program(max_blocks: int, max_goals: int, robot_first: bool,
                    static_shapes, device):
    """:func:`program_arrays` on `device`, made once per scene and device
    (as ``physics_kernel._tables`` caches K1's tables), so that a render
    copies nothing from the host."""
    key = (max_blocks, max_goals, robot_first, static_shapes, str(device))
    if key not in _PROGRAMS:
        arrays = program_arrays(max_blocks, max_goals, robot_first,
                                static_shapes)
        if torch.device(device).type == 'cuda':
            out = (ctypes.c_int * 4)()
            _build.library().render_program_layout(out)
            want = (PROG_I, PROG_F, arrays[2].size, arrays[3].size)
            if tuple(out) != want:
                raise RuntimeError(f'display program layout mismatch: '
                                   f'kernel {tuple(out)}, python {want}')
        _PROGRAMS[key] = tuple(torch.from_numpy(x).to(device)
                               for x in arrays)
    return _PROGRAMS[key]


def kernel_display(state: EnvState, max_blocks: int, max_goals: int,
                   robot_first: bool, static_shapes=None):
    """The batched display list of the plain ``build_display_list``, with
    the static per-slot kinds and line widths: what each kernel builds in
    its blocks, for the tests and for counting a render's work.  No
    kernel reads it."""
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


def prim_screen_bboxes(disp, state: EnvState, view: str, res: int):
    """The plain version of the kernels' cull (``prim_screen_bbox``,
    csrc/render_lo.cuh) on the camera grid at `res` (4x the output's for
    K4): each prim's screen box, (B, P, 4) as (u_min, u_max, w_min, w_max)
    in pixel-centre units (pixel (row, col) at u = col + 0.5, w = row +
    0.5), outside which its lo alpha and hi coverage are exactly 0, and
    (B, P) whether it could be bounded.  `disp` is :func:`kernel_display`'s
    list."""
    ego, scale, half, npx, npy, lw_scale = (
        torch.tensor(x, dtype=torch.float32)
        for x in camera_args(view, res)[:6])
    dev = state.device
    scale, half, npx, npy = (x.to(dev) for x in (scale, half, npx, npy))
    verts, nv, rad = disp['verts'], disp['nv'], disp['radius']
    kind, lw = disp['kind'], disp['lw']
    margin = 1.0 + torch.where(kind != render.KIND_FILL,
                               torch.clamp(lw * lw_scale.to(dev), min=1.0)
                               * 0.5, 0.0)
    r = rad + margin / scale                                   # (B, P)
    if bool(ego):
        c = torch.cos(state.angle[:, 0])[:, None, None]
        s = torch.sin(state.angle[:, 0])[:, None, None]
        rx = state.pos[:, 0, 0][:, None, None]
        ry = state.pos[:, 0, 1][:, None, None]

    def screen(x, y):                        # world (B, P, K) -> screen
        if not bool(ego):
            return (x + half) * scale, (half - y) * scale
        dx, dy = x - rx, y - ry
        spx, spy = c * dx + s * dy, -s * dx + c * dy
        return (spx + npx) * scale, float(res) - (spy + npy) * scale

    # polygons: the vertices of the polygon with every face pushed out by r
    _, _, n, valid = collision._poly_edges(verts, nv)
    idx = torch.arange(render.NV, device=dev)
    h = torch.remainder(idx - 1, nv[..., None]).long()        # face before
    nh = torch.gather(n, 2, h[..., None].expand(n.shape))
    vh = torch.gather(valid, 2, h)
    den = 1.0 + (nh[..., 0] * n[..., 0] + nh[..., 1] * n[..., 1])
    k = r[..., None] / den
    u, w = screen(verts[..., 0] + k * (nh[..., 0] + n[..., 0]),
                  verts[..., 1] + k * (nh[..., 1] + n[..., 1]))
    use = idx < nv[..., None]
    big = torch.tensor(1e30, device=dev)
    bb = torch.stack([torch.where(use, u, big).amin(-1),
                      torch.where(use, u, -big).amax(-1),
                      torch.where(use, w, big).amin(-1),
                      torch.where(use, w, -big).amax(-1)], -1)
    bounded = (~use | (vh & valid & (den >= 1e-3))).all(-1)
    # circles: the centre +- r
    cu, cw = screen(verts[..., :1, 0], verts[..., :1, 1])
    rp = (r * scale)[..., None]
    circ = torch.cat([cu - rp, cu + rp, cw - rp, cw + rp], -1)
    is_circ = nv == 1
    return (torch.where(is_circ[..., None], circ, bb),
            is_circ | bounded)


# The EnvState fields the kernels read, with their dtypes.
_SCENE_FIELDS = (('pos', torch.float32), ('angle', torch.float32),
                 ('block_shape', torch.int32), ('block_colour', torch.int32),
                 ('block_active', torch.bool), ('goal_xyhw', torch.float32),
                 ('goal_colour', torch.int32), ('goal_active', torch.bool))


# Each entry point's camera grid, as a multiple of the output resolution,
# and its tiles where the caller names none.
_ENTRIES = {'render_lo_into_slot': (1, LO_TILE),
            'render_lo_frame': (1, LO_TILE), 'render_lo_tiles2d': (1, None),
            'render_hi_into_slot': (4, HI_TILE),
            'render_hi_frame': (4, HI_TILE)}


def _launch_scene(entry: str, prog, state: EnvState, out: torch.Tensor,
                  view: str, res: int, tile=None, counters=None):
    """Kernel entry point `entry` on the state itself: the kernel builds
    each env's display list from `prog` (:func:`display_program`) and the
    state's tensors, in tiles of `tile` = (rows, cols) output pixels (the
    entry's own where None), and writes `out` (B, res, res, 3) uint8.
    ``render_hi_into_slot`` also takes `counters`, whose
    :data:`K4_COUNTERS` it adds to, or None."""
    grid, own_tile = _ENTRIES[entry]
    B, P = state.batch, prog[0].shape[0]
    if P > MAX_PRIMS:
        raise ValueError(f'{P} display prims; the kernel takes {MAX_PRIMS}')
    rows, cols = (int(x) for x in (tile or own_tile))
    if rows <= 0 or cols <= 0 or B * -(-res // rows) * -(-res // cols) \
            > 2 ** 31 - 1:
        raise ValueError(f'tile {tile} at res {res}, batch {B}')
    fields = [getattr(state, name).contiguous() for name, _ in _SCENE_FIELDS]
    items = [(name, x, dt) for (name, dt), x in zip(_SCENE_FIELDS, fields)]
    items += [('program', x, dt) for x, dt in zip(prog, (
        torch.int32, torch.float32, torch.float32, torch.int32))]
    items += [('out', out, torch.uint8)]
    for name, x, dt in items:
        if x.device != state.device or x.device.type != 'cuda':
            raise ValueError(f'{name} is on {x.device}; the kernel takes '
                             f'CUDA tensors on {state.device}')
        if x.dtype != dt:
            raise TypeError(f'{name} has dtype {x.dtype}, kernel takes {dt}')
    if tuple(out.shape) != (B, res, res, 3) or not out.is_contiguous():
        raise ValueError(f'out has shape {tuple(out.shape)}, kernel takes '
                         f'a contiguous {(B, res, res, 3)}')
    ptrs = [x.data_ptr() for x in fields + list(prog) + [out]]
    ints = [B, P, res, state.n_bodies, state.max_blocks,
            state.goal_xyhw.shape[1]]
    extra = []
    if entry == 'render_hi_into_slot':
        extra = [None if counters is None else counters.take(
            name, B, state.device).data_ptr() for name in K4_COUNTERS]
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = getattr(_build.library(), entry)(
        *ptrs, *ints, *camera_args(view, grid * res), rows, cols, *extra,
        stream)
    _build.check(rc, entry)


def _fresh(wrapper, entry: str, fidelity: str, state: EnvState, scene,
           res: int, views, static_shapes, tile=None):
    """Fresh frames through kernel entry point `entry` (over `tile`, or
    its own tiles), counted on `wrapper`; on a CPU state, the plain render
    at `fidelity`.  `scene` is (max_blocks, max_goals, robot_first)."""
    if state.device.type == 'cpu':
        return render.render_views(state, *scene, res=res, views=views,
                                   fidelity=fidelity,
                                   static_shapes=static_shapes)
    prog = display_program(*scene, static_shapes, state.device)
    out = {}
    for view in views:
        frame = torch.empty((state.batch, res, res, 3), dtype=torch.uint8,
                            device=state.device)
        _launch_scene(entry, prog, state, frame, view, res, tile)
        wrapper.launches += 1
        out[view] = frame
    return out


def _into_slots(wrapper, entry: str, fidelity: str, state: EnvState,
                rings: dict, t: int, scene, spec, res: int, static_shapes,
                counters=None):
    """Step-`t` frames into their ring slots through `entry` (with
    `counters`, see :func:`_launch_scene`), counted on `wrapper`; on a CPU
    state, the plain render copied in.  Either in one ``magical.render``
    span (:mod:`trace`)."""
    with trace.span('magical.render'):
        if state.device.type == 'cpu':
            return preproc.push_frames_cf(spec, rings, render.render_views(
                state, *scene, res=res, views=spec.views, fidelity=fidelity,
                static_shapes=static_shapes), t)
        prog = display_program(*scene, static_shapes, state.device)
        for view in spec.views:
            ring = rings[view]
            depth = spec.depth(view)
            if ring.dim() != 5 or ring.shape[0] != depth:
                raise ValueError(f'{view} ring has shape '
                                 f'{tuple(ring.shape)}, want ({depth}, B, '
                                 f'{res}, {res}, 3)')
            _launch_scene(entry, prog, state, ring[t % depth], view, res,
                          counters=counters)
            wrapper.launches += 1
        return rings


def render_views_lo(state: EnvState, max_blocks: int, max_goals: int,
                    robot_first: bool, res: int = 96,
                    views=('allo', 'ego'), static_shapes=None,
                    tiles2d=None):
    """Fresh lo-fidelity frames {view: (B, res, res, 3) uint8}: K3, or K5
    (:func:`render_lo_tiles2d`) where `tiles2d` = (row_tile, col_tile)
    names the pixel tiles, each of which must divide `res`.

    On a CUDA state it launches the kernel once per view; on a CPU state
    it is the plain ``render.render_views(..., fidelity='lo')``."""
    scene = (max_blocks, max_goals, robot_first)
    if tiles2d is not None:
        return render_lo_tiles2d(state, *scene, tiles2d, res=res, views=views,
                                 static_shapes=static_shapes)
    return _fresh(render_views_lo, 'render_lo_frame', 'lo', state, scene,
                  res, views, static_shapes)


render_views_lo.launches = 0


def render_lo_tiles2d(state: EnvState, max_blocks: int, max_goals: int,
                      robot_first: bool, tiles2d, res: int = 96,
                      views=('allo', 'ego'), static_shapes=None):
    """K5: fresh lo frames {view: (B, res, res, 3) uint8} composited over
    (row_tile, col_tile) pixel tiles, each tile over the prims whose screen
    box meets it (:func:`prim_screen_bboxes`), built from the state as K3
    builds them.  Equal to :func:`render_views_lo`'s frames; on a CPU state
    it is the plain lo render.  Raises unless both tile sides divide
    `res`."""
    row_tile, col_tile = (int(x) for x in tiles2d)
    if row_tile <= 0 or col_tile <= 0 or res % row_tile or res % col_tile:
        raise ValueError(f'tiles2d {tuple(tiles2d)} must divide res {res} '
                         f'on both axes')
    return _fresh(render_lo_tiles2d, 'render_lo_tiles2d', 'lo', state,
                  (max_blocks, max_goals, robot_first), res, views,
                  static_shapes, (row_tile, col_tile))


render_lo_tiles2d.launches = 0


def render_into_slots(state: EnvState, rings: dict, t: int, max_blocks: int,
                      max_goals: int, robot_first: bool, spec, res: int = 96,
                      static_shapes=None):
    """Render the step-`t` lo frame of every view of `spec` into slot
    ``t mod depth`` of its ring (``rings[view]``: (depth, B, res, res, 3)
    uint8), IN PLACE (K2); returns `rings`.

    On a CUDA state it launches the kernel once per view, writing the
    ring slot directly; on a CPU state it renders with the plain
    ``render.render_views`` and copies the frames in."""
    return _into_slots(render_into_slots, 'render_lo_into_slot', 'lo', state,
                       rings, t, (max_blocks, max_goals, robot_first), spec,
                       res, static_shapes)


render_into_slots.launches = 0


def render_views_hi(state: EnvState, max_blocks: int, max_goals: int,
                    robot_first: bool, res: int = 96,
                    views=('allo', 'ego'), static_shapes=None):
    """Fresh hi-fidelity frames {view: (B, res, res, 3) uint8} (K4), at
    res 96 (the preprocessors) or 384 (raw observations).

    On a CUDA state it launches the kernel once per view; on a CPU state
    it is the plain ``render.render_views(..., fidelity='hi')``."""
    return _fresh(render_views_hi, 'render_hi_frame', 'hi', state,
                  (max_blocks, max_goals, robot_first), res, views,
                  static_shapes)


render_views_hi.launches = 0


def render_hi_into_slots(state: EnvState, rings: dict, t: int,
                         max_blocks: int, max_goals: int, robot_first: bool,
                         spec, res: int = 96, static_shapes=None,
                         counters: trace.KernelCounters | None = None):
    """Render the step-`t` hi frame of every view of `spec` into slot
    ``t mod depth`` of its ring, IN PLACE (K4); returns `rings`.  With
    `counters`, K4 adds each env's counts of :data:`K4_PHASES`,
    :data:`K4_ITEMS` and :data:`K4_PIXELS`, over its blocks and views, to
    its ``k4_cycles``, ``k4_items`` and ``k4_pixels``.  On a CPU state it
    renders with the plain hi render, copies the frames in and counts
    nothing."""
    return _into_slots(render_hi_into_slots, 'render_hi_into_slot', 'hi',
                       state, rings, t, (max_blocks, max_goals, robot_first),
                       spec, res, static_shapes, counters)


render_hi_into_slots.launches = 0
