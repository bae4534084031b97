"""Batched narrowphase collision routines.

The PyTorch counterpart of ``magical_tpu/core/collision.py``.  Every
collider is a convex polygon of up to ``NV`` vertices with an outset
radius (a circle is a 1-vertex "poly" with a large radius).  Where the
JAX functions describe one shape pair and are ``vmap``-ed, these take any
number of leading batch dimensions: ``verts`` is (..., NV, 2), ``nv`` and
``radius`` are (...).

Conventions:
  * polygons are CCW; padded vertex rows repeat the last real vertex
  * contact normals point from shape A to shape B
  * a contact is active iff dist < 0 (penetration), matching Chipmunk's
    non-speculative contact generation
"""

from __future__ import annotations

import numpy as np
import torch

from magical_tpu_torch.geometry import NV

_EPS = 1e-9
_BIG = 1e9


def _take(x, idx):
    """x (..., N, D) or (..., N) indexed along N by idx (...) -> (..., D)
    or (...)."""
    if x.dim() == idx.dim() + 2:
        g = idx[..., None, None].expand(*idx.shape, 1, x.shape[-1])
        return torch.gather(x, -2, g)[..., 0, :]
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _norm2(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def rot2(angle):
    """(…,) angle -> (…, 2, 2) rotation matrix."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def transform_verts(verts, pos, angle):
    """Local (…, NV, 2) verts -> world frame, for pose pos (…, 2) and
    angle (…)."""
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    x = c * verts[..., 0] - s * verts[..., 1] + pos[..., None, 0]
    y = s * verts[..., 0] + c * verts[..., 1] + pos[..., None, 1]
    return torch.stack([x, y], -1)


def _poly_edges(verts, nv):
    """Per-edge (start, end, outward normal, valid) for CCW polys with `nv`
    real vertices stored in padded (…, NV, 2) `verts` (or in fewer rows,
    as long as they hold all `nv`)."""
    idx = torch.arange(verts.shape[-2], device=verts.device)
    nv = torch.as_tensor(nv, device=verts.device)[..., None]
    nxt = torch.where(idx + 1 < nv, idx + 1, 0)
    nxt = nxt.expand(*verts.shape[:-1])
    v0 = verts
    v1 = torch.gather(verts, -2, nxt[..., None].expand(*verts.shape))
    e = v1 - v0
    elen = _norm2(e)
    n = torch.stack([e[..., 1], -e[..., 0]], -1) \
        / torch.clamp(elen, min=_EPS)[..., None]
    valid = (idx < nv) & (elen > _EPS)
    return v0, v1, n, valid


def circle_circle(ca, ra, cb, rb):
    """Single contact between two circles (cpCollideCircles semantics)."""
    d = cb - ca
    dist_c = _norm2(d)
    n = d / torch.clamp(dist_c, min=_EPS)[..., None]
    dist = dist_c - (ra + rb)
    point = ca + n * (ra + 0.5 * dist)[..., None]
    return point, n, dist


def circle_poly(c, rc, verts, nv, rpoly):
    """Contact between circles (centre c (…, 2), radius rc) and convex
    polys.  Returns (point, normal, dist) with the normal pointing from
    the POLY towards the CIRCLE (closest boundary point when outside)."""
    v0, v1, n, valid = _poly_edges(verts, nv)
    rel = c[..., None, :] - v0
    # face separations of the centre
    sep = torch.where(valid, _dot2(n, rel), -_BIG)
    inside = torch.amax(sep, -1) <= 0.0

    # deepest face when inside
    f = torch.argmax(sep, -1)
    n_in = _take(n, f)
    dist_in = _take(sep, f) - rpoly - rc

    # closest boundary point when outside
    e = v1 - v0
    ee = torch.clamp(_dot2(e, e), min=_EPS)
    tproj = torch.clamp(_dot2(rel, e) / ee, 0.0, 1.0)
    q = v0 + tproj[..., None] * e
    dq = _norm2(c[..., None, :] - q)
    dq = torch.where(valid, dq, _BIG)
    j = torch.argmin(dq, -1)
    qj = _take(q, j)
    dqj_raw = _take(dq, j)
    n_out = (c - qj) / torch.clamp(dqj_raw, min=_EPS)[..., None]
    dist_out = dqj_raw - rpoly - rc

    normal = torch.where(inside[..., None], n_in, n_out)
    dist = torch.where(inside, dist_in, dist_out)
    point = c - normal * (rc + 0.5 * dist)[..., None]
    return point, normal, dist


def poly_poly(va, nva, ra, vb, nvb, rb):
    """Up to two contacts between two convex polys (SAT + reference-face
    clipping, the classic Chipmunk/Box2D construction).

    Returns (points (…,2,2), normal (…,2), dists (…,2), valids (…,2))."""
    dev = va.device
    a0, _, an, avalid = _poly_edges(va, nva)
    b0, _, bn, bvalid = _poly_edges(vb, nvb)

    # SAT over A's faces: support of B along -an.
    dots_ab = an[..., :, None, 0] * vb[..., None, :, 0] \
        + an[..., :, None, 1] * vb[..., None, :, 1]          # (…, F, V)
    minsB = torch.amin(dots_ab, -1)
    sepA = torch.where(avalid, minsB - _dot2(an, a0), -_BIG)
    iA = torch.argmax(sepA, -1)
    sA = _take(sepA, iA)

    dots_ba = bn[..., :, None, 0] * va[..., None, :, 0] \
        + bn[..., :, None, 1] * va[..., None, :, 1]
    minsA = torch.amin(dots_ba, -1)
    sepB = torch.where(bvalid, minsA - _dot2(bn, b0), -_BIG)
    iB = torch.argmax(sepB, -1)
    sB = _take(sepB, iB)

    use_a = sA >= sB
    ua = use_a[..., None]
    sep = torch.where(use_a, sA, sB)

    # reference face data
    nva = torch.as_tensor(nva, device=dev)
    nvb = torch.as_tensor(nvb, device=dev)
    nxtA = torch.where(iA + 1 < nva, iA + 1, 0)
    nxtB = torch.where(iB + 1 < nvb, iB + 1, 0)
    refp0 = torch.where(ua, _take(va, iA), _take(vb, iB))
    refp1 = torch.where(ua, _take(va, nxtA), _take(vb, nxtB))
    refm = torch.where(ua, _take(an, iA), _take(bn, iB))
    # contact normal always points A -> B
    normal = torch.where(ua, refm, -refm)

    # incident face: on the other poly, face most anti-parallel to refm
    inc_n = torch.where(ua[..., None], bn, an)
    inc_valid = torch.where(ua, bvalid, avalid)
    scores = torch.where(inc_valid, _dot2(inc_n, refm[..., None, :]), _BIG)
    ji = torch.argmin(scores, -1)
    inc_v = torch.where(ua[..., None], vb, va)
    inc_nv = torch.where(use_a, nvb, nva)
    p1 = _take(inc_v, ji)
    p2 = _take(inc_v, torch.where(ji + 1 < inc_nv, ji + 1, 0))

    # clip incident segment to the reference face's side planes
    t = refp1 - refp0
    tlen = torch.clamp(_norm2(t), min=_EPS)
    t = t / tlen[..., None]
    x1 = _dot2(t, p1 - refp0)
    x2 = _dot2(t, p2 - refp0)
    dx = x2 - x1
    safe_dx = torch.where(torch.abs(dx) > _EPS, dx,
                          torch.full_like(dx, _EPS))
    # param s in [0,1] along p1->p2 restricted to x in [0, tlen]
    s_at0 = (0.0 - x1) / safe_dx
    s_atL = (tlen - x1) / safe_dx
    s_lo = torch.clamp(torch.minimum(s_at0, s_atL), 0.0, 1.0)
    s_hi = torch.clamp(torch.maximum(s_at0, s_atL), 0.0, 1.0)
    c1 = p1 + s_lo[..., None] * (p2 - p1)
    c2 = p1 + s_hi[..., None] * (p2 - p1)

    rsum = ra + rb
    d1 = _dot2(refm, c1 - refp0) - rsum
    d2 = _dot2(refm, c2 - refp0) - rsum
    overlap = sep - rsum < 0.0
    valids = torch.stack([overlap & (d1 < 0.0), overlap & (d2 < 0.0)], -1)
    points = torch.stack([c1, c2], -2)
    dists = torch.stack([d1, d2], -1)
    normals = torch.stack([normal, normal], -2)
    return points, normals, dists, valids


def pair_contacts(va, nva, ra, vb, nvb, rb):
    """Dispatch on circle-ness (nv == 1) and return up to two contacts
    (points (…,2,2), normals (…,2,2), dists (…,2), valids (…,2)).

    Row 0 of a circle's padded vert array is its centre."""
    a_circ = (nva == 1)
    b_circ = (nvb == 1)

    cc_pt, cc_n, cc_d = circle_circle(va[..., 0, :], ra, vb[..., 0, :], rb)
    # circle(A)-poly(B): circle_poly's normal points poly->circle = B->A,
    # so flip it for the A->B convention.
    cpab_pt, cpab_n, cpab_d = circle_poly(va[..., 0, :], ra, vb, nvb, rb)
    # poly(A)-circle(B): normal poly->circle = A->B already.
    cpba_pt, cpba_n, cpba_d = circle_poly(vb[..., 0, :], rb, va, nva, ra)
    pp_pts, pp_ns, pp_ds, pp_vs = poly_poly(va, nva, ra, vb, nvb, rb)

    cc = (a_circ & b_circ)[..., None]
    ac = a_circ[..., None]
    one_pt = torch.where(cc, cc_pt, torch.where(ac, cpab_pt, cpba_pt))
    one_n = torch.where(cc, cc_n, torch.where(ac, -cpab_n, cpba_n))
    one_d = torch.where(a_circ & b_circ, cc_d,
                        torch.where(a_circ, cpab_d, cpba_d))

    any_circ = a_circ | b_circ
    anc = any_circ[..., None]
    points = torch.where(anc[..., None], torch.stack([one_pt, one_pt], -2),
                         pp_pts)
    normals = torch.where(anc[..., None], torch.stack([one_n, one_n], -2),
                          pp_ns)
    dists = torch.where(anc, torch.stack([one_d, one_d], -1), pp_ds)
    valids = torch.where(
        anc, torch.stack([one_d < 0.0, torch.zeros_like(one_d, dtype=bool)],
                         -1), pp_vs)
    return points, normals, dists, valids


# Arena walls as inward half-planes (ArenaBoundaries: four static segments
# of radius 1 just outside [-1,1]^2 — inside the arena their surfaces are
# exactly the lines x=±1, y=±1).
WALL_NORMALS = np.array(
    [[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]], dtype=np.float32)
WALL_OFFSETS = np.array([-1.0, -1.0, -1.0, -1.0], dtype=np.float32)
N_WALLS = 4


def wall_contacts_for_slot(wverts, nv, radius, wall_n, wall_o):
    """Up to two contacts between shape slots (world verts (…, NV, 2)) and
    one wall half-plane {x : dot(wall_n, x) >= wall_o}; `wall_n` is a (2,)
    tensor and `wall_o` a float.

    Mirrors Chipmunk segment-vs-poly, which clips to at most two points.
    Returns (points (…,2,2), normal (2,), dists (…,2), valids (…,2))."""
    idx = torch.arange(NV, device=wverts.device)
    nv = torch.as_tensor(nv, device=wverts.device)[..., None]
    seps = wverts[..., 0] * wall_n[0] + wverts[..., 1] * wall_n[1] \
        - wall_o - radius[..., None]
    seps = torch.where(idx < nv, seps, _BIG)
    i1 = torch.argmin(seps, -1)
    s1 = _take(seps, i1)
    seps2 = torch.where(idx == i1[..., None], _BIG, seps)
    i2 = torch.argmin(seps2, -1)
    s2 = _take(seps2, i2)
    p1 = _take(wverts, i1) - wall_n * radius[..., None]
    p2 = _take(wverts, i2) - wall_n * radius[..., None]
    points = torch.stack([p1, p2], -2)
    dists = torch.stack([s1, s2], -1)
    valids = dists < 0.0
    return points, wall_n, dists, valids
