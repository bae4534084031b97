"""Layout randomisation, batched over envs.

The PyTorch counterpart of ``magical_tpu/tasks/randomize.py``.  The
reference randomises entity poses by rejection sampling against the live
pymunk space (geom.py:116-341); here every env draws a fixed batch of
``N_TRIES`` pose proposals per entity, all of them are tested against the
already-placed entities with a vectorised SAT overlap test, and the first
acceptable one is taken (the last one when none is).

Entity geometry for placement is uniform: every placeable entity (robot,
block, goal region) is up to ``KSUB`` convex sub-shapes with an outset
radius, in the entity's local frame, as a tuple ``(verts (B, KSUB, NV, 2),
radius (B, KSUB), nv (B, KSUB) i32, active (B, KSUB) bool)`` with the env
axis first.  Goal region sensors take part in the overlap tests as in the
reference's shape_query.

The draw and the placement are split: :func:`place_entity` draws the
uniforms from a ``torch.Generator`` and :func:`place_from_proposals` turns
given uniforms into poses, so that a test can feed the JAX package's
uniforms to the port.

Every draw of a reset goes through :func:`rand` or :func:`randint`, which
take a ``torch.Generator`` or a :class:`RowSlice` of one: the rows
``[start, start + batch)`` of the draws a reset of the whole global batch
makes, so that a data-parallel rank's envs are bit for bit those rows of a
one-process reset.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch import geometry as G
from magical_tpu_torch.core import collision as col
from magical_tpu_torch.core.state import f32

NV = G.NV
KSUB = G.KSUB
N_TRIES = 128          # proposals evaluated per entity placement
_BIG = 1e9


# ---------------------------------------------------------------------------
# Draws, whole or a rank's rows of a global batch
# ---------------------------------------------------------------------------

class RowSlice:
    """`generator` drawing for a batch of `global_batch` envs of which the
    caller keeps rows ``[start, start + B)``: every draw of shape (B, ...)
    draws (global_batch, ...) and keeps those rows."""

    def __init__(self, generator: torch.Generator, global_batch: int,
                 start: int):
        self.generator = generator
        self.global_batch = int(global_batch)
        self.start = int(start)

    @property
    def device(self):
        return self.generator.device


def _draw(fn, generator, shape, device, *args):
    shape = tuple(shape)
    if isinstance(generator, RowSlice):
        if generator.start + shape[0] > generator.global_batch:
            raise ValueError(
                f'rows [{generator.start}, {generator.start + shape[0]}) '
                f'are not rows of a batch of {generator.global_batch}')
        full = fn(*args, (generator.global_batch,) + shape[1:],
                  generator=generator.generator, device=generator.device)
        return full[generator.start:generator.start + shape[0]]
    return fn(*args, shape, generator=generator,
              device=device if generator is None else generator.device)


def rand(generator, shape, device=None):
    """Uniforms in [0, 1) of `shape` from `generator` (a generator, a
    :class:`RowSlice` or None for the global one, then on `device`), on
    the generator's device."""
    return _draw(torch.rand, generator, shape, device)


def randint(generator, low: int, high: int, shape, device=None):
    """Integers in [low, high) (int64) of `shape`, drawn as :func:`rand`
    draws."""
    return _draw(torch.randint, generator, shape, device, low, high)


# ---------------------------------------------------------------------------
# Placement geometry builders
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def robot_placement_geom():
    """Robot as KSUB sub-shapes in the *robot body* frame, with fingers at
    their canonical reset offsets (entities.py:307-331): body circle + 4
    finger boxes.  numpy, one env."""
    verts = np.zeros((KSUB, NV, 2), np.float32)
    radius = np.zeros((KSUB,), np.float32)
    nv = np.ones((KSUB,), np.int32)
    active = np.zeros((KSUB,), bool)
    radius[0] = C.ROBOT_RAD
    active[0] = True
    rg = G.ROBOT_GEOM
    s = 1
    for side in range(2):
        delta = rg['finger_init_delta'][side]
        rel = rg['finger_rel_pos'][side]
        cd, sd = np.cos(delta), np.sin(delta)
        R = np.array([[cd, -sd], [sd, cd]], np.float32)
        for k in range(2):
            poly = rg['finger_polys'][side, k] @ R.T + rel
            verts[s, :4] = poly
            verts[s, 4:] = poly[-1]
            nv[s] = 4
            active[s] = True
            s += 1
    return verts, radius, nv, active


def goal_placement_geom(h, w):
    """Goal region sensor box as a 1-sub-shape entity (entities.py:794-798),
    per env: `h`, `w` are (B,) tensors."""
    B, dev = h.shape[0], h.device
    hw = torch.stack([w / 2, h / 2], -1)
    signs = f32([[1, 1], [-1, 1], [-1, -1], [1, -1]], dev)
    box = hw[:, None, :] * signs                       # (B, 4, 2)
    verts = torch.zeros((B, KSUB, NV, 2), dtype=torch.float32, device=dev)
    verts[:, 0, :4] = box
    verts[:, 0, 4:] = box[:, 3:4]
    radius = torch.zeros((B, KSUB), dtype=torch.float32, device=dev)
    nv = torch.ones((B, KSUB), dtype=torch.int32, device=dev)
    nv[:, 0] = 4
    active = torch.zeros((B, KSUB), dtype=torch.bool, device=dev)
    active[:, 0] = True
    return verts, radius, nv, active


def block_placement_geom(shape_code):
    """Blocks as their KSUB convex parts, gathered per env by type code
    (`shape_code` (B,) int tensor)."""
    dev = shape_code.device
    s = shape_code.long()
    return (f32(G.BLOCK_VERTS, dev)[s], f32(G.BLOCK_SUB_RADIUS, dev)[s],
            torch.as_tensor(G.BLOCK_SUB_NV, dtype=torch.int32,
                            device=dev)[s],
            torch.as_tensor(G.BLOCK_SUB_ACTIVE, dtype=torch.bool,
                            device=dev)[s])


# ---------------------------------------------------------------------------
# SAT overlap test between convex sub-shapes
# ---------------------------------------------------------------------------

def _sat_overlap(va, nva, ra, vb, nvb, rb, need=(True, True, True, True)):
    """Boolean overlap between convex padded polys (world frame), handling
    the 1-vertex circle case via closest-point distance.  `va`, `vb` are
    (..., V, 2) with V >= every nv, the rest (...), all with the same
    leading shape.  `need` says which of the circle-circle, circle-poly,
    poly-circle and poly-poly cases occur; the others are not computed."""
    a_circ = nva == 1
    b_circ = nvb == 1
    rsum = ra + rb
    none = torch.zeros(rsum.shape, dtype=torch.bool, device=rsum.device)
    cc = ab = ba = pp = none
    if need[0]:                         # circle-circle
        cc = col._norm2(vb[..., 0, :] - va[..., 0, :]) < rsum
    if need[1]:                         # circle-poly, either order
        ab = col.circle_poly(va[..., 0, :], ra, vb, nvb, rb)[2] < 0
    if need[2]:
        ba = col.circle_poly(vb[..., 0, :], rb, va, nva, ra)[2] < 0
    if need[3]:                         # poly-poly SAT (exact for convex)
        a0, _, an, avalid = col._poly_edges(va, nva)
        b0, _, bn, bvalid = col._poly_edges(vb, nvb)

        def sep_of(n, p0, other):       # min over `other`'s verts
            dots = n[..., :, None, 0] * other[..., None, :, 0] \
                + n[..., :, None, 1] * other[..., None, :, 1]
            return torch.amin(dots, -1) - col._dot2(n, p0)

        sep = torch.maximum(
            torch.amax(torch.where(avalid, sep_of(an, a0, vb), -_BIG), -1),
            torch.amax(torch.where(bvalid, sep_of(bn, b0, va), -_BIG), -1))
        pp = sep < rsum
    return torch.where(a_circ & b_circ, cc,
                       torch.where(a_circ, ab, torch.where(b_circ, ba, pp)))


def _entity_overlap(ent_a, ent_b):
    """Any-pair overlap between entities `ent_a` and `ent_b`, world-frame
    (verts (..., KSUB, NV, 2), radius, nv, active (..., KSUB)) tuples with
    the same leading shape; returns (...) bool.

    What the batch holds decides the work: sub-shape pairs that no env has
    active are skipped, only the circle/poly cases that occur are computed,
    and vertex rows past the largest vertex count (padding, which repeats
    the last vertex) are dropped.  None of it changes a result."""
    va, ra, nva, acta = ent_a
    vb, rb, nvb, actb = ent_b

    def kinds(nv, act):                 # per sub-shape slot: (circle, poly)
        c = ((nv == 1) & act).reshape(-1, KSUB).any(0)
        p = ((nv != 1) & act).reshape(-1, KSUB).any(0)
        return list(zip(c.tolist(), p.tolist()))

    ka, kb = kinds(nva, acta), kinds(nvb, actb)
    nmax = int(torch.maximum(torch.where(acta, nva, 1).max(),
                             torch.where(actb, nvb, 1).max()))
    va, vb = va[..., :nmax, :], vb[..., :nmax, :]
    hit = torch.zeros(acta.shape[:-1], dtype=torch.bool, device=va.device)
    for i in range(KSUB):
        for j in range(KSUB):
            (ca, pa), (cb, pb) = ka[i], kb[j]
            need = (ca and cb, ca and pb, pa and cb, pa and pb)
            if not any(need):
                continue
            o = _sat_overlap(va[..., i, :, :], nva[..., i], ra[..., i],
                             vb[..., j, :, :], nvb[..., j], rb[..., j], need)
            hit |= o & acta[..., i] & actb[..., j]
    return hit


def _inside_arena(verts, rad, nv, act):
    """True where the entity (world frame, (..., KSUB, NV, 2)) overlaps no
    arena wall; returns (...) bool."""
    dev = verts.device
    idx = torch.arange(NV, device=dev)
    vmask = (idx < nv[..., None]) & act[..., None]          # (..., KSUB, NV)
    wn = f32(col.WALL_NORMALS, dev)
    seps = verts[..., None, 0] * wn[:, 0] + verts[..., None, 1] * wn[:, 1] \
        - f32(col.WALL_OFFSETS, dev) - rad[..., None, None]
    ok = torch.where(vmask[..., None], seps, _BIG) > 0.0
    return ok.flatten(-3).all(-1)


# ---------------------------------------------------------------------------
# The placement primitive
# ---------------------------------------------------------------------------

def transform_entity(geom, pos, angle):
    """Local entity geometry -> world frame, for poses `pos` (..., 2) and
    `angle` (...) whose leading shape the geometry broadcasts to."""
    verts, rad, nv, act = geom
    lead = pos.shape[:-1]
    verts = verts.expand(lead + verts.shape[-3:])
    w = col.transform_verts(
        verts, pos[..., None, :].expand(lead + (KSUB, 2)),
        angle[..., None].expand(lead + (KSUB,)))
    return (w, rad.expand(lead + (KSUB,)), nv.expand(lead + (KSUB,)),
            act.expand(lead + (KSUB,)))


def place_from_proposals(u_pos, u_ang, ent_geom, cur_pos, cur_angle, placed,
                         placed_mask, rand_pos=True, rand_rot=True,
                         pos_linf_limit=None, rot_limit=None):
    """Poses from given uniforms (pm_randomise_pose, geom.py:116-264): the
    first of each env's proposals that stays inside the arena and overlaps
    no placed entity, else its last proposal.

    Args:
      u_pos: (B, T, 2) and u_ang: (B, T) uniforms in [0, 1).
      ent_geom: the entity's local geometry, per env.
      cur_pos (B, 2), cur_angle (B,): current pose (centre of the jitter
        box).
      placed: world-frame geometry of already-placed entities, each field
        with (B, E) leading dims; placed_mask: (B, E) bool, which of them
        to collide against.

    Returns (pos (B, 2), angle (B,), ok (B,) bool)."""
    arena_l, arena_r, arena_b, arena_t = C.ARENA_BOUNDS_LRBT
    if pos_linf_limit is not None:
        x_lo = torch.clamp(cur_pos[:, 0] - pos_linf_limit, min=arena_l)
        x_hi = torch.clamp(cur_pos[:, 0] + pos_linf_limit, max=arena_r)
        y_lo = torch.clamp(cur_pos[:, 1] - pos_linf_limit, min=arena_b)
        y_hi = torch.clamp(cur_pos[:, 1] + pos_linf_limit, max=arena_t)
        x_lo, x_hi, y_lo, y_hi = (v[:, None] for v in (x_lo, x_hi, y_lo,
                                                       y_hi))
    else:
        x_lo, x_hi, y_lo, y_hi = arena_l, arena_r, arena_b, arena_t
    if rot_limit is not None:
        r_lo = (cur_angle - rot_limit)[:, None]
        r_hi = (cur_angle + rot_limit)[:, None]
    else:
        r_lo, r_hi = -math.pi, math.pi
    B, T = u_ang.shape
    props_pos = torch.stack([x_lo + u_pos[..., 0] * (x_hi - x_lo),
                             y_lo + u_pos[..., 1] * (y_hi - y_lo)], -1)
    if not rand_pos:
        props_pos = cur_pos[:, None, :].expand(B, T, 2)
    props_ang = r_lo + u_ang * (r_hi - r_lo)
    if not rand_rot:
        props_ang = cur_angle[:, None].expand(B, T)

    geom = tuple(x[:, None] for x in ent_geom)               # (B, 1, ...)
    ent = transform_entity(geom, props_pos, props_ang)       # (B, T, ...)
    ok = _inside_arena(*ent)
    E = placed_mask.shape[1]
    if E:
        lead = (B, T, E)
        a = tuple(x[:, :, None].expand(lead + x.shape[2:]) for x in ent)
        b = tuple(x[:, None].expand(lead + x.shape[2:]) for x in placed)
        hits = _entity_overlap(a, b) & placed_mask[:, None, :]
        ok = ok & ~hits.any(-1)
    any_ok = ok.any(-1)
    first = torch.argmax(ok.to(torch.int32), -1)
    pick = torch.where(any_ok, first, T - 1)
    rows = torch.arange(B, device=pick.device)
    return props_pos[rows, pick], props_ang[rows, pick], any_ok


def _uniform(generator: torch.Generator, shape, device):
    return rand(generator, shape).to(device)


def place_entity(generator: torch.Generator, ent_geom, cur_pos, cur_angle,
                 placed, placed_mask, rand_pos=True, rand_rot=True,
                 pos_linf_limit=None, rot_limit=None, n_tries=N_TRIES):
    """Sample a non-colliding pose per env: draws `n_tries` proposals from
    `generator` and places with :func:`place_from_proposals`."""
    B, dev = cur_pos.shape[0], cur_pos.device
    u_pos = _uniform(generator, (B, n_tries, 2), dev)
    u_ang = _uniform(generator, (B, n_tries), dev)
    return place_from_proposals(u_pos, u_ang, ent_geom, cur_pos, cur_angle,
                                placed, placed_mask, rand_pos=rand_pos,
                                rand_rot=rand_rot,
                                pos_linf_limit=pos_linf_limit,
                                rot_limit=rot_limit)


def hw_from_uniform(u, min_side, max_side, current_hw=None, linf_bound=None):
    """geom.py:344-359 — goal height/width from uniforms `u` (B, 2);
    `current_hw` is a pair of (B,) tensors.  Returns (h, w), (B,) each."""
    dev = u.device
    minima = f32([min_side, min_side], dev)
    maxima = f32([max_side, max_side], dev)
    if linf_bound is not None:
        cur = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                           device=dev).expand(u.shape[0])
                           for x in current_hw], -1)
        minima = torch.maximum(minima, cur - linf_bound)
        maxima = torch.minimum(maxima, cur + linf_bound)
    hw = minima + u * (maxima - minima)
    return hw[:, 0], hw[:, 1]


def randomise_hw(generator: torch.Generator, batch: int, min_side, max_side,
                 device, current_hw=None, linf_bound=None):
    """Uniform goal height/width randomisation, per env: draws from
    `generator` and applies :func:`hw_from_uniform`."""
    return hw_from_uniform(_uniform(generator, (batch, 2), device),
                           min_side, max_side, current_hw, linf_bound)
