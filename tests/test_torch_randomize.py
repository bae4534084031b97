"""magical_tpu_torch's layout randomisation and Test-variant resets against
magical_tpu's.

Placement is held on the same random numbers: the uniforms that JAX's
``place_entity`` draws from a key are fed to the port's
``place_from_proposals``.  Whole resets draw from different generators
(threefry and torch's), so they are held in distribution, as
tests/test_reset_ks.py holds the JAX package's two samplers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magical_tpu import constants as JC
from magical_tpu.tasks import ALL_TASKS as JT
from magical_tpu.tasks import base as JB
from magical_tpu.tasks import move_to_corner as JMTC
from magical_tpu.tasks import randomize as JR
from magical_tpu_torch.tasks import ALL_TASKS as TT
from magical_tpu_torch.tasks import move_to_corner as TMTC
from magical_tpu_torch.tasks import randomize as TR

from _torch_port import jax_to_torch
from test_reset_ks import ks_2samp, prop_diff_ok

B = 64
# Same uniforms, same float32 operations: poses agree to rounding (XLA may
# contract the proposal and transform arithmetic into FMAs).
POSE_ATOL = 1e-6
N = 512
KS_P_MIN = 1e-3


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _jax_place(rand_rot, limited, rot_limited):
    """vmapped JAX place_entity; the limits are traced arguments."""
    def one(key, geom, cur_pos, cur_ang, placed, mask, pos_lim, rot_lim):
        return JR.place_entity(key, geom, cur_pos, cur_ang, placed, mask,
                               rand_rot=rand_rot,
                               pos_linf_limit=pos_lim if limited else None,
                               rot_limit=rot_lim if rot_limited else None)
    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, None, None)))


@jax.jit
@jax.vmap
def _jax_uniforms(key):
    """The uniforms place_entity draws from `key`."""
    kp, kr = jax.random.split(key)
    return (jax.random.uniform(kp, (JR.N_TRIES, 2)),
            jax.random.uniform(kr, (JR.N_TRIES,)))


def _obstacles(rng, crowded):
    """Per-env obstacles, JAX world frame: a robot at a random pose and a
    goal region of random size (`crowded`: one goal that covers the whole
    arena, so that no proposal fits)."""
    def one(rpos, rang, ghw, gpos):
        st = JB.Stack(2)
        if crowded:
            st.put(0, JR.goal_placement_geom(jnp.float32(2.5),
                                             jnp.float32(2.5)),
                   jnp.zeros(2), jnp.float32(0.0))
        else:
            st.put(0, JB.robot_geom(), rpos, rang)
            st.put(1, JR.goal_placement_geom(ghw[0], ghw[1]), gpos,
                   jnp.float32(0.0))
        return st.placed(), st.mask
    f32 = functools.partial(jnp.asarray, dtype=jnp.float32)
    return jax.vmap(one)(f32(rng.uniform(-0.7, 0.7, (B, 2))),
                         f32(rng.uniform(-np.pi, np.pi, B)),
                         f32(rng.uniform(0.5, 0.8, (B, 2))),
                         f32(rng.uniform(-0.6, 0.6, (B, 2))))


def _entity(kind, rng):
    if kind == 'robot':
        return tuple(jnp.broadcast_to(x, (B,) + x.shape)
                     for x in JB.robot_geom())
    if kind == 'goal':
        hw = jnp.asarray(rng.uniform(0.5, 0.8, (B, 2)), jnp.float32)
        return jax.vmap(JR.goal_placement_geom)(hw[:, 0], hw[:, 1])
    # every shape a Test variant draws
    shapes = np.resize(np.asarray(JC.RAND_SHAPE_TYPES, np.int32), B)
    return jax.vmap(JR.block_placement_geom)(jnp.asarray(shapes))


@pytest.mark.parametrize('task', ['MoveToCorner', 'MoveToRegion'])
def test_task_tables_match(task):
    j, t = JT[task], TT[task]
    assert (t.max_blocks, t.max_goals, t.ep_len, t.variants) == \
        (j.max_blocks, j.max_goals, j.ep_len, j.variants)
    for v in j.variants:
        jf, tf = j.flags_for(v), t.flags_for(v)
        assert (jf.colour, jf.shape, jf.count, jf.layout_minor,
                jf.layout_full, jf.dynamics) == (
            tf.colour, tf.shape, tf.count, tf.layout_minor, tf.layout_full,
            tf.dynamics), v
        assert t.static_block_shapes(tf) == j.static_block_shapes(jf), v
        assert t.reachable_shape_types(tf) == j.reachable_shape_types(jf), v


@pytest.mark.parametrize('case,kind,obstacles,jitter', [
    (0, 'robot', 'none', False), (1, 'robot', 'none', True),
    (2, 'goal', 'none', False), (3, 'goal', 'none', True),
    (4, 'block', 'placed', False), (5, 'block', 'placed', True),
    (6, 'robot', 'crowded', False),
])
def test_place_from_proposals_matches_place_entity(case, kind, obstacles,
                                                   jitter):
    rng = np.random.default_rng(case)
    geom = _entity(kind, rng)
    placed, mask = _obstacles(rng, crowded=obstacles == 'crowded')
    if obstacles == 'none':
        mask = jnp.zeros_like(mask)
    cur_pos = jnp.asarray(rng.uniform(-0.8, 0.8, (B, 2)), jnp.float32)
    cur_ang = jnp.asarray(rng.uniform(-np.pi, np.pi, B), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(case), B)
    rand_rot = kind != 'goal'
    pos_lim = JC.JITTER_POS_BOUND if jitter else None
    rot_lim = JC.JITTER_ROT_BOUND if jitter and rand_rot else None
    jp, ja, jok = _jax_place(rand_rot, pos_lim is not None,
                             rot_lim is not None)(
        keys, geom, cur_pos, cur_ang, placed, mask,
        jnp.float32(JC.JITTER_POS_BOUND), jnp.float32(JC.JITTER_ROT_BOUND))
    u_pos, u_ang = (_t(u) for u in _jax_uniforms(keys))
    args = (tuple(_t(x) for x in geom), _t(cur_pos), _t(cur_ang),
            tuple(_t(x) for x in placed))
    kw = dict(rand_rot=rand_rot, pos_linf_limit=pos_lim, rot_limit=rot_lim)
    tp, ta, tok = TR.place_from_proposals(u_pos, u_ang, *args, _t(mask),
                                          **kw)
    np.testing.assert_array_equal(tok.numpy(), _np(jok))
    np.testing.assert_allclose(tp.numpy(), _np(jp), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(ta.numpy(), _np(ja), rtol=0, atol=POSE_ATOL)
    if obstacles == 'crowded':
        assert not _np(jok).any()              # the last proposal, each
    elif obstacles == 'placed':
        assert _np(jok).any()
        # without its obstacles an env would have taken an earlier pose
        free, _, _ = TR.place_from_proposals(
            u_pos, u_ang, *args, torch.zeros_like(_t(mask)), **kw)
        assert bool((free != tp).any())


@pytest.mark.parametrize('jitter', [False, True])
def test_randomise_hw_matches(jitter):
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    cur = (jnp.float32(0.76), jnp.float32(0.75))
    bound = JC.JITTER_TARGET_BOUND if jitter else None
    jh, jw = jax.vmap(lambda k: JR.randomise_hw(
        k, JC.RAND_GOAL_MIN_SIZE, JC.RAND_GOAL_MAX_SIZE, current_hw=cur,
        linf_bound=bound))(keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (2,)))(keys)
    th, tw = TR.hw_from_uniform(
        _t(u), JC.RAND_GOAL_MIN_SIZE, JC.RAND_GOAL_MAX_SIZE,
        current_hw=(torch.tensor(0.76), torch.tensor(0.75)),
        linf_bound=bound)
    np.testing.assert_allclose(th.numpy(), _np(jh), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(tw.numpy(), _np(jw), rtol=0, atol=POSE_ATOL)


# ---------------------------------------------------------------------------
# Whole resets, in distribution
# ---------------------------------------------------------------------------

FIELDS = ('pos', 'angle', 'block_shape', 'block_colour', 'block_active',
          'goal_xyhw', 'goal_colour', 'goal_active', 'phys', 'place_fail')


@functools.lru_cache(maxsize=None)
def _jax_resets(task, variant):
    """N JAX resets (the score tests reuse the first B of them)."""
    t = JT[task]
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    return jax.device_get(jax.jit(jax.vmap(
        lambda k: t.reset_fn(k, t.flags_for(variant))))(keys))


def _port_resets(task, variant):
    t = TT[task]
    st = t.reset_fn(torch.Generator().manual_seed(0), N,
                    t.flags_for(variant), 'cpu')
    return {f: getattr(st, f).numpy() for f in FIELDS}


@pytest.mark.parametrize('task,variant', [
    ('MoveToCorner', 'TestJitter'), ('MoveToCorner', 'TestAll'),
    ('MoveToRegion', 'TestLayout'), ('MoveToRegion', 'TestAll')])
def test_reset_distributions_match(task, variant):
    js = _jax_resets(task, variant)
    j = {f: np.asarray(getattr(js, f)) for f in FIELDS}
    t = _port_resets(task, variant)
    failures = []

    def ks(name, a, b):
        a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
        if a.std() < 1e-9 and b.std() < 1e-9:
            if abs(a.mean() - b.mean()) > 1e-6:
                failures.append((name, 'const', a.mean(), b.mean()))
            return
        d, p = ks_2samp(a, b)
        if p < KS_P_MIN:
            failures.append((name, 'ks', d, p))

    def prop(name, a, b):
        bad = prop_diff_ok(a, b, np.unique(np.concatenate([a, b])))
        if bad:
            failures.append((name, 'prop', bad))

    ks('robot_x', j['pos'][:, 0, 0], t['pos'][:, 0, 0])
    ks('robot_y', j['pos'][:, 0, 1], t['pos'][:, 0, 1])
    ks('robot_cos', np.cos(j['angle'][:, 0]), np.cos(t['angle'][:, 0]))
    ks('robot_sin', np.sin(j['angle'][:, 0]), np.sin(t['angle'][:, 0]))
    act = j['block_active'][:, 0]
    np.testing.assert_array_equal(t['block_active'][:, 0], act)
    if act.any():
        ks('block_x', j['pos'][act, 5, 0], t['pos'][act, 5, 0])
        ks('block_y', j['pos'][act, 5, 1], t['pos'][act, 5, 1])
        ks('block_cos', np.cos(j['angle'][act, 5]),
           np.cos(t['angle'][act, 5]))
        prop('block_shape', j['block_shape'][act, 0],
             t['block_shape'][act, 0])
        prop('block_colour', j['block_colour'][act, 0],
             t['block_colour'][act, 0])
    gact = j['goal_active'][:, 0]
    np.testing.assert_array_equal(t['goal_active'][:, 0], gact)
    if gact.any():
        for i, nm in enumerate(('goal_x', 'goal_y', 'goal_h', 'goal_w')):
            ks(nm, j['goal_xyhw'][gact, 0, i], t['goal_xyhw'][gact, 0, i])
        prop('goal_colour', j['goal_colour'][gact, 0],
             t['goal_colour'][gact, 0])
    for i in range(j['phys'].shape[1]):
        ks(f'phys_{i}', j['phys'][:, i], t['phys'][:, i])
    prop('place_fail', j['place_fail'] > 0, t['place_fail'] > 0)
    assert not failures, failures


# ---------------------------------------------------------------------------
# Scores on identical states
# ---------------------------------------------------------------------------

def _moved_states(task, variant, seed):
    """B JAX TestAll reset states with the robot and block moved to random
    poses, so that scores take all their values."""
    st = jax.tree_util.tree_map(lambda x: x[:B],
                                _jax_resets(task, variant))
    rng = np.random.default_rng(seed)
    pos = np.array(st.pos)
    pos[:, 0] = rng.uniform(-1.0, 1.0, (B, 2))
    pos[:, 5] = np.where(st.block_active[:, :1], rng.uniform(
        -1.0, 1.0, (B, 2)), pos[:, 5])
    return st.replace(pos=jnp.asarray(pos, jnp.float32))


def test_move_to_region_score_matches():
    js = _moved_states('MoveToRegion', 'TestAll', 3)
    want = np.asarray(jax.vmap(JT['MoveToRegion'].score_fn)(js))
    got = TT['MoveToRegion'].score_fn(jax_to_torch(js)).numpy()
    assert 0 < want.sum() < B                  # both values occur
    np.testing.assert_array_equal(got, want)


def test_debug_shaped_reward_matches():
    js = _moved_states('MoveToCorner', 'TestAll', 5)
    want = np.asarray(jax.vmap(JMTC.debug_shaped_reward)(js))
    got = TMTC.debug_shaped_reward(jax_to_torch(js)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
