"""The benchmark's frozen copy of ``magical_tpu_torch/core/physics.py``,
part of the plain reference that decides a run's `correct`.  It
imports nothing of the port, so that no later change to the port
moves the yardstick; its float type is ``dtype.F``.

Batched rigid-body physics with Chipmunk-2D semantics, in plain PyTorch.

The PyTorch counterpart of ``magical_tpu/core/physics.py``, and the plain
version of the CUDA control-step kernel (``core/physics_kernel.py``).  It
runs the same sequential-impulse scheme over the batched
:class:`EnvState`:

  * narrowphase evaluates ONE flat static candidate list (all wall/
    shape-pair contacts) per substep;
  * valid contacts are compacted to a fixed per-task budget, in stable
    candidate order, with later ones dropped;
  * the solver runs Chipmunk's accumulated-impulse iteration with
    *mass-splitting Jacobi* sweeps over the contact set, followed by a
    Gauss-Seidel sweep over the joints;
  * positions integrate at the start of each substep from the previous
    velocities plus the pseudo-velocities (v_bias/w_bias).

Where the JAX module gathers and scatters through one-hot einsums (a TPU
idiom), this one uses ``gather`` and ``scatter_add_`` over the env-first
batch.  Contact caches (``con_id``/``con_jn``/``con_jt``) and joint
accumulators (``joint_acc``) carry across substeps and control steps.

Joint semantics (all used by the reference):
  PivotJoint velocity servo        entities.py:255-258, 703-707
  GearJoint heading servo/damper   entities.py:259-263, 708-711
  PinJoint finger attachment       entities.py:334-341
  RotaryLimitJoint finger limits   entities.py:343-346
  SimpleMotor finger drive         entities.py:349-354
  DampedRotarySpring googly eyes   entities.py:266-277
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference import dtype as DT

from portbench.reference import constants as C
from portbench.reference import geometry as G
from portbench.reference import collision as col
from portbench.reference.state import (EnvState, N_ROBOT_BODIES, f32,
                                          inv_mass_arrays, max_contacts)

KSUB = G.KSUB
NV = G.NV

# Contact bias fraction per substep (Chipmunk: 1 - collisionBias**dt).
CONTACT_BIAS_COEF = C.bias_coef(C.COLLISION_BIAS, C.DT)


def _cross(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _perp(v):
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def _norm(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


# ---------------------------------------------------------------------------
# Static slot / candidate tables (numpy, identical to magical_tpu's)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def slot_tables(max_blocks: int):
    """Static per-collision-slot metadata (body, friction).

    Slots: 0 robot body circle; 1-2 finger L sub-boxes; 3-4 finger R
    sub-boxes; then KSUB slots per block."""
    ns = 5 + max_blocks * KSUB
    body = np.zeros(ns, np.int32)
    friction = np.zeros(ns, np.float32)
    body[0] = 0
    friction[0] = C.ROBOT_BODY_FRICTION
    for side in range(2):           # 0 = left (body 1), 1 = right (body 2)
        for k in range(2):
            s = 1 + side * 2 + k
            body[s] = 1 + side
            friction[s] = C.FINGER_FRICTION
    for b in range(max_blocks):
        for k in range(KSUB):
            s = 5 + b * KSUB + k
            body[s] = N_ROBOT_BODIES + b
            friction[s] = C.SHAPE_FRICTION
    return body, friction


@functools.lru_cache(maxsize=None)
def pair_table(max_blocks: int):
    """Static shape-pair candidate list (slot_a, slot_b): robot sub-shapes
    vs every block sub-shape, plus all block-block sub-shape pairs.  No
    robot-robot pairs (shared ShapeFilter group) and no intra-block
    pairs."""
    sa, sb = [], []
    for b in range(max_blocks):
        for s in range(5):
            for k in range(KSUB):
                sa.append(s)
                sb.append(5 + b * KSUB + k)
    for b1 in range(max_blocks):
        for b2 in range(b1 + 1, max_blocks):
            for k1 in range(KSUB):
                for k2 in range(KSUB):
                    sa.append(5 + b1 * KSUB + k1)
                    sb.append(5 + b2 * KSUB + k2)
    return np.asarray(sa, np.int32), np.asarray(sb, np.int32)


@functools.lru_cache(maxsize=None)
def candidate_bodies(max_blocks: int):
    """Static per-candidate (body_a, body_b, friction) in candidate order:
    [4 walls x NS slots x 2 pts] then [pairs x 2 pts].  Walls are the
    static body row index NB."""
    slot_body, slot_friction = slot_tables(max_blocks)
    nb = N_ROBOT_BODIES + max_blocks
    ns = len(slot_body)
    ba, bb, fr = [], [], []
    for _w in range(col.N_WALLS):
        for s in range(ns):
            for _p in range(2):
                ba.append(nb)
                bb.append(slot_body[s])
                fr.append(slot_friction[s] * C.WALL_FRICTION)
    sa, sb = pair_table(max_blocks)
    for i in range(len(sa)):
        for _p in range(2):
            ba.append(slot_body[sa[i]])
            bb.append(slot_body[sb[i]])
            fr.append(slot_friction[sa[i]] * slot_friction[sb[i]])
    return (np.asarray(ba, np.int32), np.asarray(bb, np.int32),
            np.asarray(fr, np.float32))


@functools.lru_cache(maxsize=None)
def robot_slot_geometry():
    """Local verts (5, NV, 2), nv (5,), radius (5,) of the robot's five
    collision slots: the body circle and the four finger sub-boxes."""
    rg = G.ROBOT_GEOM
    rverts = np.zeros((5, NV, 2), np.float32)
    for side in range(2):
        for k in range(2):
            poly = rg['finger_polys'][side, k]          # (4, 2)
            padded = np.concatenate([poly, np.repeat(poly[-1:], NV - 4, 0)])
            rverts[1 + side * 2 + k] = padded
    rnv = np.array([1, 4, 4, 4, 4], np.int32)
    rrad = np.array([C.ROBOT_RAD, 0, 0, 0, 0], np.float32)
    return rverts, rnv, rrad


# ---------------------------------------------------------------------------
# Per-env slot geometry
# ---------------------------------------------------------------------------

def slot_geometry(state: EnvState):
    """Per-slot geometry: local verts (B,NS,NV,2), nv (B,NS) i64, radius
    (B,NS), active (B,NS)."""
    mb = state.max_blocks
    dev = state.device
    B = state.batch
    rverts, rnv, rrad = robot_slot_geometry()
    verts = f32(rverts, dev).expand(B, -1, -1, -1)
    nv = torch.as_tensor(rnv, device=dev).long().expand(B, -1)
    radius = f32(rrad, dev).expand(B, -1)
    active = torch.ones((B, 5), dtype=torch.bool, device=dev)
    if mb == 0:
        return verts, nv, radius, active
    bs = state.block_shape.long()                          # (B, MB)
    bverts = f32(G.BLOCK_VERTS, dev)[bs]                   # (B,MB,KSUB,NV,2)
    bnv = torch.as_tensor(G.BLOCK_SUB_NV, device=dev).long()[bs]
    brad = f32(G.BLOCK_SUB_RADIUS, dev)[bs]
    bact = torch.as_tensor(G.BLOCK_SUB_ACTIVE, device=dev)[bs] \
        & state.block_active[:, :, None]
    return (torch.cat([verts, bverts.reshape(B, mb * KSUB, NV, 2)], 1),
            torch.cat([nv, bnv.reshape(B, -1)], 1),
            torch.cat([radius, brad.reshape(B, -1)], 1),
            torch.cat([active, bact.reshape(B, -1)], 1))


# ---------------------------------------------------------------------------
# Contact compaction + solve
# ---------------------------------------------------------------------------

def _compact_contacts(pts, nrm, dst, vld, max_blocks):
    """Select up to MAXC valid contacts per env, in stable candidate order;
    valid candidates past the budget are dropped.  pts/nrm (B,KC,2),
    dst/vld (B,KC)."""
    ba, bb, fr = candidate_bodies(max_blocks)
    maxc = max_contacts(max_blocks)
    dev = pts.device
    B, kc = vld.shape
    tgt = torch.cumsum(vld.to(torch.int64), -1) - 1     # slot per valid
    keep = vld & (tgt < maxc)
    slot = torch.where(keep, tgt, maxc)                 # maxc = discard

    def take(x):
        shape = (B, maxc + 1) + tuple(x.shape[2:])
        idx = slot.reshape(B, kc, *([1] * (x.dim() - 2))).expand(x.shape)
        out = torch.zeros(shape, dtype=x.dtype, device=dev)
        return out.scatter_(1, idx, x)[:, :maxc]

    def table(x):
        return torch.as_tensor(x, device=dev).expand(B, -1)

    valid_c = take(keep)
    cand = torch.arange(kc, dtype=torch.int32, device=dev).expand(B, -1)
    return dict(
        points=take(pts), normals=take(nrm), dists=take(dst),
        valid=valid_c,
        cand_id=torch.where(valid_c, take(cand), -1),
        body_a=take(table(ba).long()),
        body_b=take(table(bb).long()),
        friction=take(table(fr)))


def _gat(x, idx, valid_f):
    """Per-contact gather of per-body x (B,NBP[,2]) at body idx (B,K),
    zero for invalid contacts."""
    if x.dim() == 3:
        g = torch.gather(x, 1, idx[..., None].expand(-1, -1, 2))
        return g * valid_f[..., None]
    return torch.gather(x, 1, idx) * valid_f


def _acc(idx, x, valid_f, nbp):
    """Per-body sum of per-contact x (B,K[,2]) at body idx (B,K)."""
    if x.dim() == 3:
        out = torch.zeros(x.shape[0], nbp, 2, dtype=x.dtype, device=x.device)
        return out.scatter_add_(1, idx[..., None].expand(-1, -1, 2),
                                x * valid_f[..., None])
    out = torch.zeros(x.shape[0], nbp, dtype=x.dtype, device=x.device)
    return out.scatter_add_(1, idx, x * valid_f)


def _contact_prestep(con, pos_p, inv_m_p, inv_i_p):
    """cpArbiterPreStep over the compacted contact set, with mass-splitting
    Jacobi stiffness."""
    nbp = pos_p.shape[-2]
    valid_f = con['valid'].to(DT.F)
    ia, ib = con['body_a'], con['body_b']
    # per-body active contact degree for mass splitting
    deg = torch.zeros_like(inv_m_p).scatter_add_(1, ia, valid_f) \
        .scatter_add_(1, ib, valid_f)
    deg = torch.clamp(deg, min=1.0)
    invm_split = inv_m_p * deg
    invi_split = inv_i_p * deg

    r1 = con['points'] - _gat(pos_p, ia, valid_f)
    r2 = con['points'] - _gat(pos_p, ib, valid_f)
    n = con['normals']
    invm_a = _gat(invm_split, ia, valid_f)
    invm_b = _gat(invm_split, ib, valid_f)
    invi_a = _gat(invi_split, ia, valid_f)
    invi_b = _gat(invi_split, ib, valid_f)

    def k_scalar(axis):
        rcn1 = _cross(r1, axis)
        rcn2 = _cross(r2, axis)
        return invm_a + invm_b + invi_a * rcn1 ** 2 + invi_b * rcn2 ** 2

    n_mass = 1.0 / torch.clamp(k_scalar(n), min=1e-12)
    t_mass = 1.0 / torch.clamp(k_scalar(_perp(n)), min=1e-12)
    bias = -CONTACT_BIAS_COEF * torch.clamp(
        con['dists'] + C.COLLISION_SLOP, max=0.0) / C.DT
    # impulses are applied with the TRUE inverse masses; splitting only
    # enters the effective per-contact stiffness above
    return dict(ia=ia, ib=ib, valid_f=valid_f, nbp=nbp,
                r1=r1, r2=r2, n=n, n_mass=n_mass, t_mass=t_mass,
                bias=bias, valid=con['valid'], u=con['friction'],
                invm_a=_gat(inv_m_p, ia, valid_f),
                invm_b=_gat(inv_m_p, ib, valid_f),
                invi_a=_gat(inv_i_p, ia, valid_f),
                invi_b=_gat(inv_i_p, ib, valid_f))


def _apply_delta(con, v, w, dj):
    """Add per-contact impulse dj (B,K,2) to bodies with the true inverse
    masses: -dj on body A, +dj on body B."""
    ia, ib, vf, nbp = con['ia'], con['ib'], con['valid_f'], con['nbp']
    v = v + _acc(ia, -dj * con['invm_a'][..., None], vf, nbp) \
        + _acc(ib, dj * con['invm_b'][..., None], vf, nbp)
    w = w + _acc(ia, -con['invi_a'] * _cross(con['r1'], dj), vf, nbp) \
        + _acc(ib, con['invi_b'] * _cross(con['r2'], dj), vf, nbp)
    return v, w


def _apply_contact_impulse(bodies, con, djn, djt):
    """Apply per-contact (normal, tangent) impulses to the bodies
    (warm start, cpArbiterApplyCachedImpulse)."""
    v, w, vb, wb = bodies
    n = con['n']
    dj = djn[..., None] * n + djt[..., None] * _perp(n)
    v, w = _apply_delta(con, v, w, dj)
    return (v, w, vb, wb)


def _warm_start_contacts(con, state):
    """Cached impulses for contacts that persist across substeps and
    control steps, matched by candidate id."""
    old_id = state.con_id
    match = (con['cand_id'][:, :, None] == old_id[:, None, :]) \
        & con['valid'][:, :, None] & (old_id >= 0)[:, None, :]
    Mf = match.to(DT.F)
    jn_w = (Mf * state.con_jn[:, None, :]).sum(-1)
    jt_w = (Mf * state.con_jt[:, None, :]).sum(-1)
    return jn_w, jt_w


def _jacc_to_vec(jacc, mb):
    parts = [jacc['pivot'], jacc['gear'][:, None], jacc['pin'],
             jacc['limit'], jacc['motor']]
    if mb > 0:
        parts += [jacc['block_pivot'].reshape(-1, 2 * mb),
                  jacc['block_gear']]
    return torch.cat(parts, 1)


def _jacc_from_vec(vec, mb):
    B = vec.shape[0]
    jacc = dict(
        pivot=vec[:, 0:2],
        gear=vec[:, 2],
        pin=vec[:, 3:5],
        limit=vec[:, 5:7],
        motor=vec[:, 7:9],
        eye_target=torch.zeros((B, 2), dtype=vec.dtype, device=vec.device),
    )
    if mb > 0:
        jacc['block_pivot'] = vec[:, 9:9 + 2 * mb].reshape(B, mb, 2)
        jacc['block_gear'] = vec[:, 9 + 2 * mb:9 + 3 * mb]
    return jacc


def _contact_iteration(bodies, con, acc):
    """One mass-splitting Jacobi sweep with Chipmunk's accumulated-impulse
    clamping: every contact reads the same pre-sweep velocities, and the
    deltas are summed per body."""
    v, w, vb, wb = bodies
    jn_acc, jt_acc, jb_acc = acc
    ia, ib, vf = con['ia'], con['ib'], con['valid_f']
    r1, r2, n = con['r1'], con['r2'], con['n']
    valid = con['valid']

    # pseudo-velocity (position correction) impulse
    vb1 = _gat(vb, ia, vf) + _perp(r1) * _gat(wb, ia, vf)[..., None]
    vb2 = _gat(vb, ib, vf) + _perp(r2) * _gat(wb, ib, vf)[..., None]
    vbn = torch.sum((vb2 - vb1) * n, -1)
    jbn = (con['bias'] - vbn) * con['n_mass']
    jb_new = torch.where(valid, torch.clamp(jb_acc + jbn, min=0.0), jb_acc)
    db = (jb_new - jb_acc)[..., None] * n

    # normal + friction impulse
    vr1 = _gat(v, ia, vf) + _perp(r1) * _gat(w, ia, vf)[..., None]
    vr2 = _gat(v, ib, vf) + _perp(r2) * _gat(w, ib, vf)[..., None]
    vr = vr2 - vr1
    vrn = torch.sum(vr * n, -1)
    jn = -vrn * con['n_mass']            # bounce = 0 (elasticity 0)
    jn_new = torch.where(valid, torch.clamp(jn_acc + jn, min=0.0), jn_acc)
    jt_max = con['u'] * jn_new
    vrt = torch.sum(vr * _perp(n), -1)
    jt = -vrt * con['t_mass']
    jt_new = torch.where(
        valid, torch.minimum(torch.maximum(jt_acc + jt, -jt_max), jt_max),
        jt_acc)

    dj = (jn_new - jn_acc)[..., None] * n \
        + (jt_new - jt_acc)[..., None] * _perp(n)
    v, w = _apply_delta(con, v, w, dj)
    vb, wb = _apply_delta(con, vb, wb, db)
    return (v, w, vb, wb), (jn_new, jt_new, jb_new)


# ---------------------------------------------------------------------------
# Joints
# ---------------------------------------------------------------------------

def _apply_joint_cached(bodies, jacc, pre, inv_m, inv_i, max_blocks):
    """Apply each constraint's cached accumulated impulse along the NEW
    prestep geometry (cpConstraint applyCachedImpulse, dt_coef = 1).
    Returns (bodies, jacc) — the rotary limit zeroes its accumulator when
    the joint is inside its limits (cpRotaryLimitJoint preStep)."""
    v, w, vb, wb = bodies
    v, w = v.clone(), w.clone()

    v[:, 0] += jacc['pivot'] * inv_m[:, 0, None]
    w[:, 0] += jacc['gear'] * inv_i[:, 0]

    limit_acc = torch.where(pre['limit_bias'] == 0.0, 0.0, jacc['limit'])
    for side in range(2):
        fb = 1 + side
        dj = jacc['pin'][:, side, None] * pre['pin_n'][:, side]
        v[:, 0] += -dj * inv_m[:, 0, None]
        w[:, 0] += -inv_i[:, 0] * _cross(pre['pin_r1'][:, side], dj)
        v[:, fb] += dj * inv_m[:, fb, None]
        dw = limit_acc[:, side] + jacc['motor'][:, side]
        w[:, 0] += -dw * inv_i[:, 0]
        w[:, fb] += dw * inv_i[:, fb]
    jacc = {**jacc, 'limit': limit_acc}

    if max_blocks > 0:
        bsl = slice(N_ROBOT_BODIES, N_ROBOT_BODIES + max_blocks)
        v[:, bsl] += jacc['block_pivot'] * inv_m[:, bsl, None]
        w[:, bsl] += jacc['block_gear'] * inv_i[:, bsl]
    return (v, w, vb, wb), jacc


def _joint_sweep(bodies, jacc, pre, inv_m, inv_i, max_blocks):
    """One Gauss-Seidel sweep over all joints, in canonical order."""
    v, w, vb, wb = bodies
    v, w = v.clone(), w.clone()
    jacc = dict(jacc)
    inv_m0 = inv_m[:, 0]
    inv_i0 = inv_i[:, 0]

    # 1. Robot pivot velocity servo (control body -> main body):
    #    v[0] -> control velocity, force-limited.
    j_max = pre['pivot_jmax']
    vr = v[:, 0] - pre['control_vel']
    j = -vr / inv_m0[:, None]
    acc_old = jacc['pivot']
    acc_new = acc_old + j
    norm = _norm(acc_new)
    scale = torch.where(norm > j_max,
                        j_max / torch.clamp(norm, min=1e-12), 1.0)
    acc_new = acc_new * scale[:, None]
    v[:, 0] += (acc_new - acc_old) * inv_m0[:, None]
    jacc['pivot'] = acc_new

    # 2. Robot gear heading servo.
    wr = w[:, 0]
    j = (pre['gear_bias'] - wr) / inv_i0
    acc_old = jacc['gear']
    acc_new = torch.minimum(torch.maximum(acc_old + j, -pre['gear_jmax']),
                            pre['gear_jmax'])
    w[:, 0] += (acc_new - acc_old) * inv_i0
    jacc['gear'] = acc_new

    # 3. Fingers: pin joint, rotary limit, simple motor per side.
    pin = jacc['pin'].clone()
    limit = jacc['limit'].clone()
    motor = jacc['motor'].clone()
    for side in range(2):
        fb = 1 + side
        # pin joint (error_bias = 0)
        n = pre['pin_n'][:, side]
        r1 = pre['pin_r1'][:, side]
        n_mass = pre['pin_nmass'][:, side]
        bias = pre['pin_bias'][:, side]
        vr1 = v[:, 0] + _perp(r1) * w[:, 0, None]
        vr2 = v[:, fb]
        vrn = torch.sum((vr2 - vr1) * n, -1)
        j = (bias - vrn) * n_mass
        acc_old = pin[:, side].clone()
        acc_new = acc_old + j
        dj = (acc_new - acc_old)[:, None] * n
        v[:, 0] += -dj * inv_m0[:, None]
        w[:, 0] += -inv_i0 * _cross(r1, dj)
        v[:, fb] += dj * inv_m[:, fb, None]
        pin[:, side] = acc_new

        # rotary limit (error_bias = 0)
        bias = pre['limit_bias'][:, side]
        i_sum = 1.0 / (inv_i0 + inv_i[:, fb])
        wr = w[:, fb] - w[:, 0]
        j = -(bias + wr) * i_sum
        acc_old = limit[:, side].clone()
        acc_new = torch.where(bias < 0.0,
                              torch.clamp(acc_old + j, min=0.0),
                              torch.clamp(acc_old + j, max=0.0))
        acc_new = torch.where(bias == 0.0, 0.0, acc_new)
        dj = torch.where(bias == 0.0, 0.0, acc_new - acc_old)
        w[:, 0] += -dj * inv_i0
        w[:, fb] += dj * inv_i[:, fb]
        limit[:, side] = acc_new

        # simple motor
        rate = pre['motor_rate'][:, side]
        j_max = pre['motor_jmax']
        wr = w[:, fb] - w[:, 0] + rate
        j = -wr * i_sum
        acc_old = motor[:, side].clone()
        acc_new = torch.minimum(torch.maximum(acc_old + j, -j_max), j_max)
        dj = acc_new - acc_old
        w[:, 0] += -dj * inv_i0
        w[:, fb] += dj * inv_i[:, fb]
        motor[:, side] = acc_new
    jacc.update(pin=pin, limit=limit, motor=motor)

    # 4. Eye damped rotary springs: damping part (the spring torque is
    #    applied in the prestep).
    eye_target = jacc['eye_target'].clone()
    for side in range(2):
        eb = 3 + side
        i_sum = 1.0 / (inv_i0 + inv_i[:, eb])
        w_coef = pre['eye_wcoef']
        wrn = w[:, 0] - w[:, eb]
        target = eye_target[:, side].clone()
        w_damp = (target - wrn) * w_coef
        new_target = wrn + w_damp
        j_damp = w_damp * i_sum
        w[:, 0] += j_damp * inv_i0
        w[:, eb] += -j_damp * inv_i[:, eb]
        eye_target[:, side] = new_target
    jacc['eye_target'] = eye_target

    # 5. Block top-down friction dampers.
    if max_blocks == 0:
        return (v, w, vb, wb), jacc
    bsl = slice(N_ROBOT_BODIES, N_ROBOT_BODIES + max_blocks)
    vblk = v[:, bsl]
    wblk = w[:, bsl]
    inv_m_b = inv_m[:, bsl]
    inv_i_b = inv_i[:, bsl]
    safe_m = torch.where(inv_m_b > 0, inv_m_b, 1.0)
    j = -vblk / safe_m[..., None]
    acc_old = jacc['block_pivot']
    acc_new = acc_old + torch.where(inv_m_b[..., None] > 0, j, 0.0)
    norm = _norm(acc_new)
    j_max = pre['block_pivot_jmax'][:, None]
    scale = torch.where(norm > j_max, j_max / torch.clamp(norm, min=1e-12),
                        1.0)
    acc_new = acc_new * scale[..., None]
    v[:, bsl] += (acc_new - acc_old) * inv_m_b[..., None]
    jacc['block_pivot'] = acc_new

    safe_i = torch.where(inv_i_b > 0, inv_i_b, 1.0)
    j = torch.where(inv_i_b > 0, -wblk / safe_i, 0.0)
    acc_old = jacc['block_gear']
    jm = pre['block_gear_jmax'][:, None]
    acc_new = torch.minimum(torch.maximum(acc_old + j, -jm), jm)
    w[:, bsl] += (acc_new - acc_old) * inv_i_b
    jacc['block_gear'] = acc_new

    return (v, w, vb, wb), jacc


# ---------------------------------------------------------------------------
# The substep
# ---------------------------------------------------------------------------

def physics_substep(state: EnvState, iterations: int = C.PHYS_ITER):
    """One 1/80 s physics substep (cpSpaceStep + Robot.update semantics)
    for every env of the batch."""
    mb = state.max_blocks
    nb = state.n_bodies
    B = state.batch
    dev = state.device
    dt = C.DT
    inv_m, inv_i = inv_mass_arrays(state)
    zcol = torch.zeros((B, 1), dtype=DT.F, device=dev)
    inv_m_p = torch.cat([inv_m, zcol], 1)
    inv_i_p = torch.cat([inv_i, zcol], 1)

    # ---- Robot.update, BEFORE integration ---------------------------------
    a0 = state.angle[:, 0]
    control_angle = a0 + state.rel_turn_angle
    control_vel = state.target_speed[:, None] * torch.stack(
        [-torch.sin(a0), torch.cos(a0)], -1)
    sides = torch.tensor([-1.0, 1.0], dtype=DT.F, device=dev)
    rel_ang = state.angle[:, 1:3] - a0[:, None]
    ang_err = rel_ang + sides * state.target_finger_angle[:, None]
    motor_rate = torch.clamp(ang_err * 10.0, -1.0, 1.0)
    motor_rate = torch.where(torch.abs(motor_rate) < 1e-4, 0.0, motor_rate)

    # ---- integrate positions (cpBodyUpdatePosition) -----------------------
    pos = state.pos + (state.vel + state.v_bias) * dt
    angle = state.angle + (state.omega + state.w_bias) * dt
    pos_p = torch.cat([pos, torch.zeros((B, 1, 2), device=dev)], 1)

    # ---- narrowphase over the flat candidate list -------------------------
    verts_local, nv, radius, active = slot_geometry(state)
    slot_body, _ = slot_tables(mb)
    sbody = torch.as_tensor(slot_body, device=dev).long()
    wverts = col.transform_verts(verts_local, pos[:, sbody],
                                 angle[:, sbody])

    # walls: (B, 4 walls, NS slots, 2 pts)
    wn = f32(col.WALL_NORMALS, dev)
    parts = [col.wall_contacts_for_slot(wverts, nv, radius, wn[w],
                                        float(col.WALL_OFFSETS[w]))
             for w in range(col.N_WALLS)]
    wpts = torch.stack([p[0] for p in parts], 1)
    wdst = torch.stack([p[2] for p in parts], 1)
    wvld = torch.stack([p[3] for p in parts], 1) & active[:, None, :, None]
    wnrm = wn[None, :, None, None, :].expand(wpts.shape)

    parts_pts = [wpts.reshape(B, -1, 2)]
    parts_nrm = [wnrm.reshape(B, -1, 2)]
    parts_dst = [wdst.reshape(B, -1)]
    parts_vld = [wvld.reshape(B, -1)]

    sa, sb = pair_table(mb)
    if len(sa):
        sa_t = torch.as_tensor(sa, device=dev).long()
        sb_t = torch.as_tensor(sb, device=dev).long()
        ppts, pnrm, pdst, pvld = col.pair_contacts(
            wverts[:, sa_t], nv[:, sa_t], radius[:, sa_t],
            wverts[:, sb_t], nv[:, sb_t], radius[:, sb_t])
        pair_ok = active[:, sa_t] & active[:, sb_t]
        pvld = pvld & pair_ok[..., None]
        parts_pts.append(ppts.reshape(B, -1, 2))
        parts_nrm.append(pnrm.reshape(B, -1, 2))
        parts_dst.append(pdst.reshape(B, -1))
        parts_vld.append(pvld.reshape(B, -1))

    con_raw = _compact_contacts(
        torch.cat(parts_pts, 1), torch.cat(parts_nrm, 1),
        torch.cat(parts_dst, 1), torch.cat(parts_vld, 1), mb)
    con = _contact_prestep(con_raw, pos_p, inv_m_p, inv_i_p)

    # ---- joint prestep ----------------------------------------------------
    phys = state.phys
    rg = G.ROBOT_GEOM
    gear_err = angle[:, 0] - control_angle
    gear_bias = torch.clamp(-gear_err / dt, -C.ROBOT_GEAR_MAX_BIAS,
                            C.ROBOT_GEAR_MAX_BIAS)
    c0 = torch.cos(angle[:, 0])[:, None]
    s0 = torch.sin(angle[:, 0])[:, None]
    rel = f32(rg['finger_rel_pos'], dev)                      # (2,2)
    anchor_a = pos[:, 0:1] + torch.stack(
        [c0 * rel[:, 0] + (-s0) * rel[:, 1],
         s0 * rel[:, 0] + c0 * rel[:, 1]], -1)                # (B,2,2)
    delta = pos[:, 1:3] - anchor_a
    dist = _norm(delta)
    pin_n = torch.where(dist[..., None] > 1e-9,
                        delta / torch.clamp(dist, min=1e-9)[..., None],
                        torch.zeros_like(delta))
    pin_r1 = anchor_a - pos[:, 0:1]
    rcn = _cross(pin_r1, pin_n)
    pin_k = inv_m_p[:, 0:1] + inv_m_p[:, 1:3] + inv_i_p[:, 0:1] * rcn ** 2
    pin_nmass = 1.0 / torch.clamp(pin_k, min=1e-12)
    pin_bias = -dist / dt        # error_bias = 0 (entities.py:340)

    lims = f32(rg['finger_rot_limits'], dev)                  # (2,2) lo, hi
    ldist = angle[:, 1:3] - angle[:, 0:1]
    pdist = torch.where(ldist > lims[:, 1], lims[:, 1] - ldist,
                        torch.where(ldist < lims[:, 0], lims[:, 0] - ldist,
                                    0.0))
    limit_bias = -pdist / dt

    v = state.vel
    w = state.omega.clone()
    for side in range(2):
        eb = 3 + side
        rel_angle = angle[:, 0] - angle[:, eb]
        j_spring = rel_angle * C.EYE_SPRING_STIFFNESS * dt
        w[:, 0] += -j_spring * inv_i[:, 0]
        w[:, eb] += j_spring * inv_i[:, eb]
    eye_isum_inv = inv_i_p[:, 0] + inv_i_p[:, 3]
    eye_wcoef = 1.0 - torch.exp(-C.EYE_SPRING_DAMPING * dt * eye_isum_inv)

    pre = dict(
        control_vel=control_vel,
        pivot_jmax=phys[:, C.PV_ROBOT_POS_FORCE] * dt,
        gear_bias=gear_bias,
        gear_jmax=phys[:, C.PV_ROBOT_ROT_FORCE] * dt,
        pin_n=pin_n, pin_r1=pin_r1, pin_nmass=pin_nmass, pin_bias=pin_bias,
        limit_bias=limit_bias,
        motor_rate=motor_rate,
        motor_jmax=phys[:, C.PV_FINGER_FORCE] * dt,
        eye_wcoef=eye_wcoef,
        block_pivot_jmax=phys[:, C.PV_SHAPE_TRANS_FORCE] * dt,
        block_gear_jmax=phys[:, C.PV_SHAPE_ROT_FORCE] * dt,
    )

    # ---- solver iterations ------------------------------------------------
    v_p = torch.cat([v, torch.zeros((B, 1, 2), device=dev)], 1)
    w_p = torch.cat([w, zcol], 1)
    vb_p = torch.zeros_like(v_p)
    wb_p = torch.zeros_like(w_p)
    maxc = max_contacts(mb)

    # ---- warm start (cpArbiterApplyCachedImpulse + constraint jAcc) -------
    bodies = (v_p, w_p, vb_p, wb_p)
    jn_w, jt_w = _warm_start_contacts(con_raw, state)
    bodies = _apply_contact_impulse(bodies, con, jn_w, jt_w)
    acc = (jn_w, jt_w, torch.zeros((B, maxc), device=dev))
    jacc = _jacc_from_vec(state.joint_acc, mb)
    bodies, jacc = _apply_joint_cached(bodies, jacc, pre, inv_m_p, inv_i_p,
                                       mb)
    for _ in range(iterations):
        bodies, acc = _contact_iteration(bodies, con, acc)
        bodies, jacc = _joint_sweep(bodies, jacc, pre, inv_m_p, inv_i_p, mb)
    v_p, w_p, vb_p, wb_p = bodies

    return state.replace(
        pos=pos, angle=angle,
        vel=v_p[:, :nb].contiguous(), omega=w_p[:, :nb].contiguous(),
        v_bias=vb_p[:, :nb].contiguous(), w_bias=wb_p[:, :nb].contiguous(),
        con_id=con_raw['cand_id'],
        con_jn=torch.where(con_raw['valid'], acc[0], 0.0),
        con_jt=torch.where(con_raw['valid'], acc[1], 0.0),
        joint_acc=_jacc_to_vec(jacc, mb))


def action_targets(action: torch.Tensor):
    """Per-env (target_speed, rel_turn_angle, target_finger_angle) for the
    discrete actions (Robot.set_action, entities.py:439-457)."""
    dev = action.device
    a = action.long()
    return (f32(C.ACTION_TARGET_SPEED, dev)[a],
            f32(C.ACTION_TURN_ANGLE, dev)[a],
            f32(C.ACTION_FINGER_ANGLE, dev)[a])


def control_step(state: EnvState, action: torch.Tensor,
                 phys_steps: int = C.PHYS_STEPS) -> EnvState:
    """One control step for every env: apply the actions (B,) and run
    `phys_steps` physics substeps (BaseEnv._phys_steps_on_frame).
    Returns a new state; the input is not modified."""
    ts, ta, tf = action_targets(action)
    state = state.replace(target_speed=ts, rel_turn_angle=ta,
                          target_finger_angle=tf)
    for _ in range(phys_steps):
        state = physics_substep(state)
    return state.replace(t=state.t + 1)
