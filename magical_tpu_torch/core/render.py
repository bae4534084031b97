"""Batched rasteriser for MAGICAL scenes, in plain PyTorch.

The PyTorch counterpart of ``magical_tpu/core/render.py``, and the plain
version of the CUDA lo-fidelity compositing kernel
(``core/render_kernel.py``).  An analytic coverage renderer over a per-env
*display list* of convex primitives, at two fidelities:

  * hi  — hard (non-antialiased) coverage at 4x resolution followed by an
          exact 4x4 box average (the reference's GL + cv2.INTER_AREA
          pipeline).
  * lo  — analytic antialiased coverage directly at the output size.

Draw order mirrors the reference's Viewer insertion order: arena fill +
border, goal regions, blocks, robot (MoveToCorner adds the robot before
its block; flag `robot_first`).  Every array carries the env axis first.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch import geometry as G
from magical_tpu_torch.core import collision as col
from magical_tpu_torch.core.state import EnvState, N_ROBOT_BODIES, f32

NV = G.NV
KSUB = G.KSUB

KIND_FILL = 0
KIND_LINE = 1          # plain outline (arena border)
KIND_LINE_STIPPLE = 2  # stippled outline (goal borders)

# line widths in *384-scale pixels*
ARENA_BORDER_LW = 1.0               # glLineWidth(0.01) clamps to 1 px
GOAL_BORDER_LW = 250 * C.GOAL_LINE_THICKNESS   # = 2.5 px (entities.py:817)


def _pad_poly(verts):
    verts = np.asarray(verts, np.float32)
    out = np.zeros((NV, 2), np.float32)
    out[:len(verts)] = verts
    out[len(verts):] = verts[-1]
    return out, len(verts)


@functools.lru_cache(maxsize=None)
def _static_prims():
    """Arena fill + border and the robot's local-frame primitives."""
    arena_fill, _ = _pad_poly(G.rect_verts(2.0, 2.0))
    robot = []
    rg = G.ROBOT_GEOM
    # finger outers then inners (entities.py:388-412)
    for side in range(2):
        for k in range(2):
            robot.append(('finger', side,
                          _pad_poly(rg['finger_polys'][side, k]),
                          C.ROBOT_COLOUR))
    for side in range(2):
        for k in range(2):
            robot.append(('finger', side,
                          _pad_poly(G.FINGER_POLYS_INNER[side, k]),
                          C.ROBOT_COLOUR_LIGHT))
    return arena_fill, robot


def _mat_vec(c, s, v):
    """Rotate (…, 2) vectors v by per-env angle (cos c, sin s), (…)."""
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1]], -1)


def build_display_list(state: EnvState, max_blocks: int, max_goals: int,
                       robot_first: bool, static_shapes=None,
                       _meta_out=None):
    """World-space display list for every env: dict of (B, P, ...) prim
    arrays (verts (B,P,NV,2), nv, radius, color (B,P,3), kind, lw,
    active).

    `static_shapes`: optional per-block-slot tuple of shape codes (int)
    or None entries — TaskDef.static_block_shapes for env families that
    randomise neither shape nor count.  Slots with a code emit only that
    shape's active sub-prims with static nv/radius; None slots emit
    nothing.

    `_meta_out`: optional list; when given, per-slot STATIC metadata
    (kind, line width, static vertex count or None, structural tag,
    statically active) is appended — harvested by static_prim_meta."""
    B = state.batch
    dev = state.device
    verts_l, colors_l, nv_l, rad_l, kind_l, lw_l, act_l = \
        [], [], [], [], [], [], []

    def per_env(x, dtype):
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        if x.dim() == 0 or x.shape[0] != B:
            x = x.expand((B,) + tuple(x.shape))
        return x

    def emit(verts, nv, radius, color, kind=KIND_FILL, lw=0.0, active=True,
             tag=None):
        if _meta_out is not None:
            _meta_out.append(
                (kind, float(lw), nv if isinstance(nv, int) else None,
                 tag, active is True))
        verts_l.append(verts.expand(B, NV, 2))
        nv_l.append(per_env(nv, torch.int32))
        rad_l.append(per_env(radius, torch.float32))
        colors_l.append(color.expand(B, 3))
        kind_l.append(per_env(kind, torch.int32))
        lw_l.append(per_env(lw, torch.float32))
        act_l.append(per_env(active, torch.bool))

    arena_fill, robot_prims = _static_prims()

    # 1. arena (entities.py:519-537)
    arena = f32(arena_fill, dev)
    emit(arena, 4, 0.0, f32([1.0, 1.0, 1.0], dev), tag='arena_fill')
    emit(arena, 4, 0.0, f32(C.ARENA_GREY, dev), kind=KIND_LINE,
         lw=ARENA_BORDER_LW, tag='arena_border')

    # 2. goal regions (entities.py:790-819): light fill + stippled border
    goal_light = f32(C.GOAL_COLOURS_LIGHT, dev)
    block_col = f32(C.BLOCK_COLOURS, dev)
    for g in range(max_goals):
        cx, cy, h, w = (state.goal_xyhw[:, g, 0], state.goal_xyhw[:, g, 1],
                        state.goal_xyhw[:, g, 2], state.goal_xyhw[:, g, 3])
        box = torch.stack([torch.stack([cx + w / 2, cy + h / 2], -1),
                           torch.stack([cx - w / 2, cy + h / 2], -1),
                           torch.stack([cx - w / 2, cy - h / 2], -1),
                           torch.stack([cx + w / 2, cy - h / 2], -1)], 1)
        box_p = torch.cat([box, box[:, 3:4].expand(B, NV - 4, 2)], 1)
        gc = state.goal_colour[:, g].long()
        emit(box_p, 4, 0.0, goal_light[gc], active=state.goal_active[:, g])
        emit(box_p, 4, 0.0, block_col[gc], kind=KIND_LINE_STIPPLE,
             lw=GOAL_BORDER_LW, active=state.goal_active[:, g])

    def emit_robot():
        # fingers (outers then inners; same colour within each group)
        for fi, (_kind, side, (verts, nv), colour) in enumerate(robot_prims):
            body = 1 + side
            wv = col.transform_verts(f32(verts, dev), state.pos[:, body],
                                     state.angle[:, body])
            emit(wv, nv, 0.0, f32(colour, dev),
                 tag='finger_outer' if fi < 4 else 'finger_inner')
        # body circles (entities.py:377-386)
        c0 = state.pos[:, 0]
        emit(c0[:, None, :], 1, C.ROBOT_RAD, f32(C.ROBOT_COLOUR_DARK, dev),
             tag='body_outer')
        emit(c0[:, None, :], 1, C.ROBOT_RAD - C.ROBOT_LINE_THICKNESS,
             f32(C.ROBOT_COLOUR, dev), tag='body_inner')
        # eyes + pupils (entities.py:414-432)
        ca, sa = torch.cos(state.angle[:, 0]), torch.sin(state.angle[:, 0])
        for side, x_sign in enumerate((-1.0, 1.0)):
            eye_local = f32([x_sign * 0.4 * C.ROBOT_RAD,
                             0.3 * C.ROBOT_RAD], dev)
            eye_c = c0 + _mat_vec(ca, sa, eye_local)
            emit(eye_c[:, None, :], 1, 0.2 * C.ROBOT_RAD,
                 f32([1.0, 1.0, 1.0], dev), tag='eye_white')
            pupil_rot = state.angle[:, 3 + side] - state.angle[:, 0]
            off = _mat_vec(torch.cos(pupil_rot), torch.sin(pupil_rot),
                           f32([0.0, 0.07 * C.ROBOT_RAD], dev))
            pupil_c = c0 + _mat_vec(ca, sa, eye_local + off)
            emit(pupil_c[:, None, :], 1, 0.12 * C.ROBOT_RAD,
                 f32([0.1, 0.1, 0.1], dev), tag='pupil')

    def emit_blocks():
        # blocks: dark outer parts then bright inner parts
        # (entities.py:713-757)
        for b in range(max_blocks):
            body = N_ROBOT_BODIES + b
            sc = None if static_shapes is None else static_shapes[b]
            if static_shapes is not None and sc is None:
                continue                       # slot never active
            bc = state.block_colour[:, b].long()
            col_out = f32(C.BLOCK_COLOURS_DARK, dev)[bc]
            col_in = f32(C.BLOCK_COLOURS, dev)[bc]
            for table, rad_t, nv_t, act_t, colr in (
                    (G.BLOCK_VERTS, G.BLOCK_SUB_RADIUS, G.BLOCK_SUB_NV,
                     G.BLOCK_SUB_ACTIVE, col_out),
                    (G.BLOCK_VERTS_INNER, G.BLOCK_SUB_RADIUS_INNER,
                     G.BLOCK_SUB_NV_INNER, G.BLOCK_SUB_ACTIVE_INNER, col_in)):
                if sc is not None:
                    # static shape: emit only this shape's active subs,
                    # with static nv/radius
                    for k in range(KSUB):
                        if not bool(act_t[sc, k]):
                            continue
                        wv = col.transform_verts(
                            f32(table[sc, k], dev), state.pos[:, body],
                            state.angle[:, body])
                        emit(wv, int(nv_t[sc, k]), float(rad_t[sc, k]),
                             colr, active=state.block_active[:, b])
                    continue
                shape = state.block_shape[:, b].long()
                for k in range(KSUB):
                    lv = f32(table, dev)[shape, k]
                    wv = col.transform_verts(lv, state.pos[:, body],
                                             state.angle[:, body])
                    emit(wv, torch.as_tensor(nv_t, device=dev)[shape, k],
                         f32(rad_t, dev)[shape, k], colr,
                         active=state.block_active[:, b]
                         & torch.as_tensor(act_t, device=dev)[shape, k])

    if robot_first:
        emit_robot()
        emit_blocks()
    else:
        emit_blocks()
        emit_robot()

    return dict(
        verts=torch.stack(verts_l, 1), nv=torch.stack(nv_l, 1),
        radius=torch.stack(rad_l, 1), color=torch.stack(colors_l, 1),
        kind=torch.stack(kind_l, 1), lw=torch.stack(lw_l, 1),
        active=torch.stack(act_l, 1))


@functools.lru_cache(maxsize=None)
def static_prim_meta(max_blocks: int, max_goals: int, robot_first: bool,
                     static_shapes=None):
    """Per-slot static metadata tuple ((kind, lw, nv-or-None, tag,
    statically active), ...) in emit order — everything about a display
    slot that does NOT depend on env state."""
    from magical_tpu_torch.core import state as S
    meta = []
    build_display_list(S.make_initial_state(1, max_blocks, max_goals, 'cpu'),
                       max_blocks, max_goals, robot_first,
                       static_shapes=static_shapes, _meta_out=meta)
    return tuple(meta)


# ---------------------------------------------------------------------------
# Cameras (gym_render.py:176-200, base_env.py:294-307)
# ---------------------------------------------------------------------------

def _pixel_centres(res: int, scale: float):
    """Screen-space pixel-centre offsets (i + 0.5) / scale, f32 numpy,
    with true division so that every device gets the same values."""
    i = np.arange(res, dtype=np.float32)
    return (i + np.float32(0.5)) / np.float32(scale), \
        (np.float32(res) - i - np.float32(0.5)) / np.float32(scale)


def allo_pixel_coords(res: int, device):
    """World coordinates (res, res, 2) of each pixel centre for the
    allocentric camera (set_bounds at +-ARENA_ZOOM_OUT); row 0 = top."""
    half = np.float32(C.ARENA_ZOOM_OUT)
    scale = res / (2 * C.ARENA_ZOOM_OUT)
    cx, _ = _pixel_centres(res, scale)
    sx = cx - half                          # columns
    sy = half - cx                          # rows (flipped)
    wx = np.broadcast_to(sx[None, :], (res, res))
    wy = np.broadcast_to(sy[:, None], (res, res))
    return f32(np.stack([wx, wy], -1), device), scale


def ego_screen_offsets(res: int):
    """Per-pixel screen offsets (res, res, 2) from the egocentric anchor
    (robot at screen (0.5, 0.15)), in world units, and the scale."""
    world_w = 2.0 * C.ARENA_ZOOM_OUT
    scale = res / world_w
    newpos = np.asarray([world_w * 0.5, world_w * 0.15], np.float32)
    sx, sy = _pixel_centres(res, scale)
    gx = np.broadcast_to(sx[None, :], (res, res))
    gy = np.broadcast_to(sy[:, None], (res, res))
    return np.stack([gx, gy], -1) - newpos, scale


def ego_pixel_coords(state: EnvState, res: int):
    """World coords (B, res, res, 2) of pixel centres for the egocentric
    camera: the screen offsets rotated by the robot angle and moved to the
    robot position (set_cam_follow)."""
    sp, scale = ego_screen_offsets(res)
    sp = f32(sp, state.device)
    c = torch.cos(state.angle[:, 0])[:, None, None]
    s = torch.sin(state.angle[:, 0])[:, None, None]
    p = state.pos[:, 0]
    x = c * sp[..., 0] - s * sp[..., 1] + p[:, 0, None, None]
    y = s * sp[..., 0] + c * sp[..., 1] + p[:, 1, None, None]
    return torch.stack([x, y], -1), scale


# ---------------------------------------------------------------------------
# Coverage evaluation
# ---------------------------------------------------------------------------

def _prim_sdf(pix, verts, nv, radius):
    """Signed distance (approx; exact sign) from pixel centres to one prim
    per env.  pix: (B, H, W, 2) or (H, W, 2); verts: (B, NV, 2); nv,
    radius: (B,)."""
    px = pix[..., 0]
    py = pix[..., 1]

    def e(x):                    # per-env (B,) -> (B, 1, 1)
        return x[:, None, None]

    dx = px - e(verts[:, 0, 0])
    dy = py - e(verts[:, 0, 1])
    d_circ = torch.sqrt(dx * dx + dy * dy) - e(radius)
    v0, _, n, valid = col._poly_edges(verts, nv)
    offs = v0[..., 0] * n[..., 0] + v0[..., 1] * n[..., 1]
    d_poly = None
    for f in range(verts.shape[-2]):
        df = torch.where(e(valid[:, f]),
                         px * e(n[:, f, 0]) + py * e(n[:, f, 1])
                         - e(offs[:, f]), -1e9)
        d_poly = df if d_poly is None else torch.maximum(d_poly, df)
    d_poly = d_poly - e(radius)
    return torch.where(e(nv == 1), d_circ, d_poly)


def _box_arclen(pix, verts):
    """Perimeter arc-length parameter of the nearest point on a box
    outline, measured CCW from vertex 0 (the stipple phase; LineStyle
    0x00FF).  verts rows 0..3 are the box corners (TR, TL, BL, BR)."""
    best_d = None
    best_s = None
    s_acc = 0.0
    for k in range(4):
        a = verts[:, k][:, None, None, :]
        ab = (verts[:, (k + 1) % 4] - verts[:, k])[:, None, None, :]
        ablen = torch.clamp(col._norm2(ab), min=1e-9)
        rel = pix - a
        t = torch.clamp((rel[..., 0] * ab[..., 0] + rel[..., 1] * ab[..., 1])
                        / ablen ** 2, 0.0, 1.0)
        proj = a + t[..., None] * ab
        d = col._norm2(pix - proj)
        s_here = s_acc + t * ablen
        if best_d is None:
            upd = d < 1e9
            best_d = torch.where(upd, d, 1e9)
            best_s = torch.where(upd, s_here, 0.0)
        else:
            upd = d < best_d
            best_d = torch.where(upd, d, best_d)
            best_s = torch.where(upd, s_here, best_s)
        s_acc = s_acc + ablen
    return best_s


def render_frame(display, pix, scale, res: int, aa: bool,
                 static_meta=None):
    """Rasterise the display list over pixel-centre world coords `pix`
    ((B,res,res,2) or (res,res,2)); returns float images (B,res,res,3) in
    [0,1].  `static_meta`: optional (kinds, lws) tuples from
    static_prim_meta, which lets plain filled prims skip the line and
    stipple maths."""
    B = display['nv'].shape[0]
    img = f32(C.BACKGROUND_COLOUR, pix.device).expand(B, res, res, 3)
    # pixel scale for this resolution relative to the 384 reference
    lw_scale = res / 384.0
    n_prims = display['nv'].shape[1]
    kinds = static_meta[0] if static_meta else [None] * n_prims
    for p in range(n_prims):
        verts = display['verts'][:, p]
        d = _prim_sdf(pix, verts, display['nv'][:, p],
                      display['radius'][:, p])
        if aa:
            alpha_fill = torch.clamp(0.5 - d * scale, 0.0, 1.0)
        else:
            alpha_fill = (d < 0.0).to(torch.float32)
        if kinds[p] == KIND_FILL:
            alpha = alpha_fill
        else:
            kind = display['kind'][:, p, None, None]
            lw = display['lw'][:, p, None, None]
            # outlines: smoothed band (GL_LINE_SMOOTH in the reference)
            half_lw_w = torch.clamp(lw * lw_scale, min=1.0) / (2.0 * scale)
            alpha_line = torch.clamp((half_lw_w - torch.abs(d)) * scale
                                     + 0.5, 0.0, 1.0)
            alpha = torch.where(kind != KIND_FILL, alpha_line, alpha_fill)
            # stipple: 8 px on / off along the perimeter (pattern 0x00FF)
            if kinds[p] is None or kinds[p] == KIND_LINE_STIPPLE:
                s = _box_arclen(pix, verts) * scale
                stipple_on = torch.remainder(torch.floor(s), 16.0) < 8.0
                alpha = torch.where(kind == KIND_LINE_STIPPLE,
                                    alpha * stipple_on.to(torch.float32),
                                    alpha)
        alpha = torch.where(display['active'][:, p, None, None], alpha, 0.0)
        colr = display['color'][:, p, None, None, :]
        img = img * (1.0 - alpha[..., None]) + colr * alpha[..., None]
    return img


def to_uint8(img):
    return torch.floor(torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5) \
        .to(torch.uint8)


def downsample4(img_u8):
    """Exact cv2.INTER_AREA for an integer 4x ratio: 4x4 box mean, over
    (B, H, W, C) images."""
    b, h, w, c = img_u8.shape
    x = img_u8.reshape(b, h // 4, 4, w // 4, 4, c).to(torch.float32)
    return torch.floor(x.mean((2, 4)) + 0.5).to(torch.uint8)


def render_views(state: EnvState, max_blocks: int, max_goals: int,
                 robot_first: bool, res: int = 96, views=('allo', 'ego'),
                 fidelity: str = 'lo', static_shapes=None):
    """Render the requested camera views to uint8 images,
    {view: (B, res, res, 3)}.

    fidelity 'hi': rasterise at 4x res with hard edges, box-average down
    (reference pipeline); 'lo': analytic AA directly at `res`."""
    display = build_display_list(state, max_blocks, max_goals, robot_first,
                                 static_shapes=static_shapes)
    meta3 = static_prim_meta(max_blocks, max_goals, robot_first,
                             static_shapes)
    meta = (tuple(m[0] for m in meta3), tuple(m[1] for m in meta3))
    out = {}
    for view in views:
        r = res * 4 if fidelity == 'hi' else res
        pix, scale = (allo_pixel_coords(r, state.device) if view == 'allo'
                      else ego_pixel_coords(state, r))
        img = render_frame(display, pix, scale, r, aa=fidelity != 'hi',
                           static_meta=meta)
        out[view] = (downsample4(to_uint8(img)) if fidelity == 'hi'
                     else to_uint8(img))
    return out
