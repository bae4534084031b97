"""magical_tpu_torch's collision and physics against magical_tpu's XLA
reference, on identical inputs (JAX states carried over as numpy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magical_tpu import geometry as JG
from magical_tpu.core import collision as JCol
from magical_tpu.core import physics as JP
from magical_tpu_torch.core import collision as TCol
from magical_tpu_torch.core import physics as TP
from magical_tpu_torch.core import physics_kernel as TPK

from _torch_port import (jax_demo_states, jax_to_numpy, jax_to_torch,
                         max_abs, nudge_pos, seek_block_actions,
                         torch_actions, torch_to_numpy)

B = 8

# ---------------------------------------------------------------------------
# Collision: every narrowphase routine on random poses of the real shapes
# ---------------------------------------------------------------------------


def _random_shapes(rng, n):
    """n random (verts (NV,2) world, nv, radius) from the block table and
    the finger boxes, posed near the origin so that pairs overlap."""
    shapes = []
    for _ in range(n):
        if rng.random() < 0.25:
            side, k = rng.integers(0, 2), rng.integers(0, 2)
            poly = JG.ROBOT_GEOM['finger_polys'][side, k]
            local = np.concatenate([poly, np.repeat(poly[-1:], 4, 0)])
            nv, rad = 4, 0.0
        else:
            t = int(rng.choice([1, 2, 3, 4, 5, 6]))
            k = 0 if t != 6 else int(rng.integers(0, 6))
            local = JG.BLOCK_VERTS[t, k]
            nv, rad = int(JG.BLOCK_SUB_NV[t, k]), float(
                JG.BLOCK_SUB_RADIUS[t, k])
        a = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(a), np.sin(a)
        pos = rng.uniform(-0.15, 0.15, 2)
        world = (local @ np.array([[c, s], [-s, c]]) + pos).astype(np.float32)
        shapes.append((world, nv, np.float32(rad)))
    return shapes


def _stack(shapes):
    v = np.stack([s[0] for s in shapes])
    nv = np.array([s[1] for s in shapes], np.int32)
    r = np.array([s[2] for s in shapes], np.float32)
    return v, nv, r


def test_collision_routines_match_on_random_poses():
    rng = np.random.default_rng(0)
    n = 256
    va, nva, ra = _stack(_random_shapes(rng, n))
    vb, nvb, rb = _stack(_random_shapes(rng, n))
    j = jax.jit(jax.vmap(JCol.pair_contacts))(
        va, nva, ra, vb, nvb, rb, va[:, 0], vb[:, 0])
    t = TCol.pair_contacts(torch.from_numpy(va), torch.from_numpy(nva).long(),
                           torch.from_numpy(ra), torch.from_numpy(vb),
                           torch.from_numpy(nvb).long(), torch.from_numpy(rb))
    jp, jn, jd, jv = (np.asarray(x) for x in j)
    tp, tn, td, tv = (x.numpy() for x in t)
    assert jv.any() and (~jv).any()
    # validity may only differ for contacts within rounding of dist = 0
    # (XLA contracts multiply-adds to FMA; the port rounds each operation)
    border = np.abs(jd) < 1e-5
    assert np.all((jv == tv) | border)
    both = jv & tv
    # same formulas, float32 rounding differences only: 1e-5 is ~100
    # ulps at the 0.1-unit magnitudes of these shapes
    np.testing.assert_allclose(tp[both], jp[both], atol=1e-5)
    np.testing.assert_allclose(tn[both], jn[both], atol=1e-5)
    np.testing.assert_allclose(td[both], jd[both], atol=1e-5)

    # circle-poly alone (closest-point normal outside, deepest face inside)
    cp_j = jax.jit(jax.vmap(JCol.circle_poly))(va[:, 0] * 3.0, rb, vb, nvb,
                                               rb)
    cp_t = TCol.circle_poly(torch.from_numpy(va[:, 0] * 3.0),
                            torch.from_numpy(rb), torch.from_numpy(vb),
                            torch.from_numpy(nvb).long(),
                            torch.from_numpy(rb))
    for x, y in zip(cp_j, cp_t):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-5)

    # walls: every slot against every wall half-plane
    for w in range(4):
        wj = jax.jit(jax.vmap(JCol.wall_contacts_for_slot,
                              in_axes=(0, 0, 0, None, None)))(
            va * 8.0, nva, ra, JCol.WALL_NORMALS[w], JCol.WALL_OFFSETS[w])
        wt = TCol.wall_contacts_for_slot(
            torch.from_numpy(va * 8.0), torch.from_numpy(nva).long(),
            torch.from_numpy(ra), torch.from_numpy(TCol.WALL_NORMALS[w]),
            float(TCol.WALL_OFFSETS[w]))
        # walls are axis-aligned: the arithmetic is exact in both
        for k in (0, 2, 3):
            np.testing.assert_array_equal(wt[k].numpy(), np.asarray(wj[k]))


# ---------------------------------------------------------------------------
# Physics: control_step from MoveToCorner-Demo states
# ---------------------------------------------------------------------------

_step = jax.jit(jax.vmap(JP.control_step))
FIELDS = ('pos', 'angle', 'vel', 'omega', 'con_jn', 'con_jt', 'joint_acc')
# One control step agrees to rounding (measured <= 3e-5 on vel): pose to
# 1e-4 as the port's target, velocities and impulse caches to 1e-3.
ONE_STEP_ATOL = {'pos': 1e-4, 'angle': 1e-4, 'vel': 1e-3, 'omega': 1e-3,
                 'con_jn': 1e-3, 'con_jt': 1e-3, 'joint_acc': 1e-3}


def _start_states(kind):
    js = jax_demo_states(B)
    acts = seek_block_actions(B, 10)
    if kind == 'contact':
        # mid-push: several envs with the block (and walls) in contact
        for i in range(5):
            js = _step(js, jnp.asarray(acts[i]))
        acts = acts[5:]
        assert (np.asarray(js.con_id) >= 0).any()
    return js, acts


@pytest.mark.parametrize('kind', ['reset', 'contact'])
def test_control_step_one_step(kind):
    js, acts = _start_states(kind)
    ts = jax_to_torch(js)
    jn = jax_to_numpy(_step(js, jnp.asarray(acts[0])))
    tn = torch_to_numpy(TP.control_step(ts, torch_actions(acts[0])))
    for f in FIELDS:
        assert max_abs(tn[f], jn[f]) <= ONE_STEP_ATOL[f], f
    np.testing.assert_array_equal(tn['con_id'], jn['con_id'])
    np.testing.assert_array_equal(tn['t'], jn['t'])
    for f in ('target_speed', 'rel_turn_angle', 'target_finger_angle'):
        np.testing.assert_array_equal(tn[f], jn[f])


@pytest.mark.parametrize('kind', ['reset', 'contact'])
def test_control_step_five_steps_within_chaos(kind):
    """Five steps carry the contact and joint caches across control steps.
    Physics is chaotic (tests/fixtures/chaos_floor.json): the port may
    diverge from the reference by no more than twice the reference's own
    divergence under a 1-ulp change of every position, or 1e-4 on pose
    (1e-3 on velocities and caches), whichever is larger."""
    js, acts = _start_states(kind)
    ts = jax_to_torch(js)
    jc = nudge_pos(js)
    for i in range(5):
        js = _step(js, jnp.asarray(acts[i]))
        jc = _step(jc, jnp.asarray(acts[i]))
        ts = TP.control_step(ts, torch_actions(acts[i]))
    jn, cn, tn = jax_to_numpy(js), jax_to_numpy(jc), torch_to_numpy(ts)
    for f in FIELDS:
        tol = max(ONE_STEP_ATOL[f], 2.0 * max_abs(cn[f], jn[f]))
        assert max_abs(tn[f], jn[f]) <= tol, f
    assert (jn['con_id'] >= 0).any()
    np.testing.assert_array_equal(tn['t'], jn['t'])


def test_compaction_keeps_candidate_order_and_budget():
    """More valid candidates than MAXC: the first MAXC in candidate order
    are kept, as in the reference."""
    mb = 1
    ba, _, _ = TP.candidate_bodies(mb)
    kc = len(ba)
    rng = np.random.default_rng(1)
    vld = rng.random((3, kc)) < 0.6
    pts = rng.standard_normal((3, kc, 2)).astype(np.float32)
    nrm = rng.standard_normal((3, kc, 2)).astype(np.float32)
    dst = -rng.random((3, kc)).astype(np.float32)
    j = jax.vmap(lambda *a: JP._compact_contacts(*a, mb))(pts, nrm, dst, vld)
    t = TP._compact_contacts(torch.from_numpy(pts), torch.from_numpy(nrm),
                             torch.from_numpy(dst), torch.from_numpy(vld),
                             mb)
    for k in ('points', 'normals', 'dists', 'valid', 'cand_id', 'body_a',
              'body_b', 'friction'):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)


def test_kernel_wrapper_takes_plain_path_on_cpu():
    js, acts = _start_states('reset')
    ts = jax_to_torch(js)
    TPK.control_step.launches = 0
    a = torch_actions(acts[0])
    out = TPK.control_step(ts, a)
    ref = TP.control_step(ts, a)
    assert TPK.control_step.launches == 0
    for f in FIELDS + ('con_id', 't'):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
