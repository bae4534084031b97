"""Work counts of a state, and the roofline bound of a count.

Copied from ``chip_smoke.py`` (``bound``, ``k1_work``, ``_prim_ops``,
``render_work``) with the port's helpers that they called
(``physics.slot_geometry``/``pair_table``, ``render_kernel.kernel_display``,
``prim_screen_bboxes``, ``camera_args``, the kernel's state fields and the
display program's size) replaced by the frozen reference's geometry and
copies of those helpers here.  A count depends on the state alone: it is
the least work that gives the step or the frames, whatever kernel computes
them.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import collision, physics, render
from portbench.reference import constants as C
from portbench.reference import geometry as G

# The H100 SXM's published peaks at 700 W (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# The state tensors a control step reads and writes (the kernel's fields).
K1_FIELDS = ('pos', 'angle', 'vel', 'omega', 'v_bias', 'w_bias',
             'target_speed', 'rel_turn_angle', 'target_finger_angle',
             'block_shape', 'block_active', 'phys', 'con_id', 'con_jn',
             'con_jt', 'joint_acc', 't')
# The state tensors a render reads.
SCENE_FIELDS = ('pos', 'angle', 'block_shape', 'block_colour',
                'block_active', 'goal_xyhw', 'goal_colour', 'goal_active')
# A display program's row: 8 int32 and 2 NV + 5 float32 (the render
# kernels' layout).
PROG_ROW_BYTES = 4 * (8 + 2 * render.NV + 5)


def bound(ops, nbytes):
    """(bound_ms, bound_by): the least time the card could take for
    `ops` float32 operations moving `nbytes` bytes."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def k1_work(state):
    """(operations, bytes) of one control step from `state` (K1): per
    substep, every slot's vertices transformed (6 ops a vertex), the 4
    walls against each active slot (60), each sub-shape pair of two active
    slots through SAT over both polygons' 8 faces and 8 vertices, incident
    face and clipping (720), and each live contact's prestep and
    warm-start match over the cache (60 + 2 MAXC); per solver iteration,
    each live contact (70) and the joint sweep (250 + 40 a block).  Bytes:
    every state tensor the step takes, read once and written once."""
    mb = state.max_blocks
    nb, ns = 5 + mb, 5 + 6 * mb
    active = physics.slot_geometry(state)[3]                # (B, NS)
    sa, sb = (torch.as_tensor(x, device=active.device).long()
              for x in physics.pair_table(mb))
    n_slots = active.sum(1).double()
    n_pairs = (active[:, sa] & active[:, sb]).sum(1).double()
    maxc = state.con_id.shape[1]
    nc = (state.con_id >= 0).sum(1).double()              # (B,)
    per_sub = (ns * 8 * 6 + 4 * n_slots * 60 + n_pairs * 720 + nb * 12
               + nc * (60 + 2 * maxc)
               + C.PHYS_ITER * (nc * 70 + 250 + 40 * mb))
    ops = float((C.PHYS_STEPS * per_sub).sum())
    nbytes = 2 * sum(getattr(state, f).nelement()
                     * getattr(state, f).element_size() for f in K1_FIELDS)
    return ops, nbytes


def display(state, max_blocks, max_goals, robot_first, static_shapes=None):
    """The batched display list of a scene, with each slot's kind and line
    width."""
    d = render.build_display_list(state, max_blocks, max_goals, robot_first,
                                  static_shapes=static_shapes)
    meta = render.static_prim_meta(max_blocks, max_goals, robot_first,
                                   static_shapes)
    dev = state.device
    return dict(
        verts=d['verts'], nv=d['nv'], radius=d['radius'],
        active=d['active'],
        kind=torch.tensor([m[0] for m in meta], dtype=torch.int32,
                          device=dev),
        lw=torch.tensor([m[1] for m in meta], dtype=torch.float32,
                        device=dev))


def program_bytes(n_prims):
    """Bytes of a scene's display program of `n_prims` rows and its shared
    tables (block sub-shape vertices, radii, vertex counts and presence,
    outer and inner, and the three colour tables)."""
    floats = sum(np.asarray(x).size for x in (
        G.BLOCK_VERTS, G.BLOCK_VERTS_INNER, G.BLOCK_SUB_RADIUS,
        G.BLOCK_SUB_RADIUS_INNER, C.GOAL_COLOURS_LIGHT, C.BLOCK_COLOURS,
        C.BLOCK_COLOURS_DARK))
    ints = sum(np.asarray(x).size for x in (
        G.BLOCK_SUB_NV, G.BLOCK_SUB_NV_INNER, G.BLOCK_SUB_ACTIVE,
        G.BLOCK_SUB_ACTIVE_INNER))
    return n_prims * PROG_ROW_BYTES + 4 * (floats + ints)


def camera(view: str, res: int):
    """(ego, scale, half, newpos x, newpos y, line-width scale) of the
    camera grid at `res`."""
    if view == 'allo':
        return 0, res / (2 * C.ARENA_ZOOM_OUT), C.ARENA_ZOOM_OUT, 0.0, \
            0.0, res / 384.0
    if view != 'ego':
        raise ValueError(f'unknown view {view!r}')
    world_w = 2.0 * C.ARENA_ZOOM_OUT
    npx, npy = (float(x) for x in np.asarray(
        [world_w * 0.5, world_w * 0.15], np.float32))
    return 1, res / world_w, C.ARENA_ZOOM_OUT, npx, npy, res / 384.0


def prim_screen_bboxes(disp, state, view: str, res: int):
    """Each prim's screen box on the camera grid at `res`, (B, P, 4) as
    (u_min, u_max, w_min, w_max) in pixel-centre units, outside which its
    lo alpha and hi coverage are exactly 0, and (B, P) whether it could be
    bounded."""
    ego, scale, half, npx, npy, lw_scale = (
        torch.tensor(x, dtype=torch.float32) for x in camera(view, res))
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


def _where64(c, a, b):
    return torch.where(c, torch.as_tensor(a, dtype=torch.float64,
                                          device=c.device),
                       torch.as_tensor(b, dtype=torch.float64,
                                       device=c.device))


def _prim_ops(disp, hard=False):
    """(B, P) operations per pixel (per subpixel if `hard`) of each
    active prim in the compositing loop: a polygon's SDF 5 a face, a
    circle's 7, coverage 4 (1 for a hard fill), an outline's band 6 more,
    a stippled one's perimeter phase 92 more, and the blend 12."""
    nv = disp['nv'].double()
    kind = disp['kind'][None, :].expand_as(disp['nv'])
    sdf = _where64(nv == 1, 7.0, 5.0 * nv + 1.0)
    cover = _where64(kind == render.KIND_FILL, 1.0 if hard else 4.0, 6.0)
    stip = _where64(kind == render.KIND_LINE_STIPPLE, 92.0, 0.0)
    return (sdf + cover + stip + 12.0) * disp['active'].double()


def _samples_in(lo, hi, n):
    """How many of the sample centres s + 0.5, 0 <= s < n, lie in
    [lo, hi]."""
    first = (lo - 0.5).ceil().clamp(0, n)
    last = (hi - 0.5).floor().clamp(-1, n - 1)
    return (last - first + 1).clamp(min=0)


def render_work(disp, state, view, res, fidelity):
    """(operations, bytes, prims per sample) of one view's frames of
    `state` at `res`: the least work that gives them.  Each pixel (at hi
    fidelity each of its 16 subpixels) is composited over the active prims
    whose cull box holds it, each prim of `disp` (:func:`display`) at its
    :func:`_prim_ops`; the camera and the quantise 22 ops a pixel or
    subpixel, the 4x4 mean 60 ops a pixel.  Bytes: the state's scene
    tensors, the display program and the uint8 frames, once each."""
    n = res * (4 if fidelity == 'hi' else 1)         # the sampled grid
    bb, bounded = prim_screen_bboxes(disp, state, view, n)
    bb = bb.double()
    area = (_samples_in(bb[..., 0], bb[..., 1], n)
            * _samples_in(bb[..., 2], bb[..., 3], n))
    area = torch.where(bounded, area, float(n * n)) \
        * disp['active'].double()                           # (B, P)
    per_prim = _prim_ops(disp, hard=fidelity == 'hi')
    ops = float((per_prim * area).sum()) + state.batch * n * n * 22 + (
        state.batch * res * res * 60 if fidelity == 'hi' else 0)
    nbytes = state.batch * res * res * 3 + program_bytes(
        disp['nv'].shape[1]) + sum(
            getattr(state, f).nelement() * getattr(state, f).element_size()
            for f in SCENE_FIELDS)
    return ops, nbytes, float(area.sum()) / (state.batch * n * n)
