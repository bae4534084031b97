"""Shared helpers of the tests that hold magical_tpu_torch against
magical_tpu: JAX states to numpy and back, and the action schedules."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from magical_tpu import constants as JC
from magical_tpu.tasks import ALL_TASKS as JAX_TASKS
from magical_tpu.tasks import randomize as JR
from magical_tpu_torch.core.convert import state_from_numpy, state_to_numpy

# The port's CPU tests run many small tensor ops, which gain nothing from
# intra-op threads; with several test workers on one host the threads
# only contend.
torch.set_num_threads(1)

A = {n: i for i, n in enumerate(JC.ACTION_NAMES)}


def jax_to_numpy(state) -> dict:
    return {f.name: np.array(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def jax_to_torch(state):
    return state_from_numpy(jax_to_numpy(state), 'cpu')


def torch_to_numpy(state) -> dict:
    return state_to_numpy(state)


def jax_demo_states(batch, task='MoveToCorner'):
    t = JAX_TASKS[task]
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    return jax.jit(jax.vmap(lambda k: t.reset_fn(k, t.flags_for('Demo'))))(
        keys)


# The six multi-block task families (the other two: MoveToCorner and
# MoveToRegion).
FAMILIES = ('FixColour', 'MakeLine', 'FindDupe', 'MatchRegions',
            'ClusterColour', 'ClusterShape')


@functools.lru_cache(maxsize=None)
def jax_resets(task, variant, n, seed=0):
    """n JAX resets of `task`'s `variant` from PRNGKey(seed), on the host."""
    t = JAX_TASKS[task]
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.device_get(jax.jit(jax.vmap(
        lambda k: t.reset_fn(k, t.flags_for(variant))))(keys))


# The fields a reset sets, and how closely two resets on the same random
# numbers agree: the same float32 operations, to rounding (XLA may
# contract the proposal and transform arithmetic into FMAs).
RESET_FIELDS = ('pos', 'angle', 'block_shape', 'block_colour',
                'block_active', 'goal_xyhw', 'goal_colour', 'goal_active',
                'phys', 'place_fail')
RESET_POSE_ATOL = 1e-6


def assert_resets_equal(tstate, jn):
    """A port reset state against a JAX reset as numpy: floats within
    RESET_POSE_ATOL, ints and bools equal."""
    for f in RESET_FIELDS:
        a, b = getattr(tstate, f).numpy(), jn[f]
        assert a.shape == b.shape, f
        if b.dtype.kind == 'f':
            np.testing.assert_allclose(a, b, rtol=0, atol=RESET_POSE_ATOL,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def seek_block_actions(batch, n_steps):
    """(n_steps, B) int32: turn towards the block for 1-3 steps, then push
    it with the fingers open (first half of the envs) or closed."""
    seqs = []
    for b in range(batch):
        n_turn = 1 + b % 3
        push = 'UpOpen' if b < batch // 2 else 'UpClose'
        seqs.append([A['UpLeftOpen']] * n_turn
                    + [A[push]] * (n_steps - n_turn))
    return np.asarray(seqs, np.int32).T


def nudge_pos(jstate):
    """The JAX state with every position moved by one ulp (towards +inf):
    the input change that measures the reference's own chaos."""
    p = np.nextafter(np.asarray(jstate.pos), np.float32(np.inf))
    return jstate.replace(pos=jnp.asarray(p))


def nudges(jstate):
    """The JAX state with every position, or every angle, moved by one ulp
    in either direction: four inputs whose outputs bound the reference's
    own chaos (the first control step from a reset is sensitive to the
    angles too, where a finger starts at its joint limit)."""
    out = []
    for f in ('pos', 'angle'):
        for d in (np.inf, -np.inf):
            x = np.nextafter(np.asarray(getattr(jstate, f)), np.float32(d))
            out.append(jstate.replace(**{f: jnp.asarray(x)}))
    return out


def max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def torch_actions(a):
    return torch.as_tensor(np.asarray(a, np.int32))


# ---------------------------------------------------------------------------
# A slice against the JAX package's BatchedEnv
# ---------------------------------------------------------------------------

# Frames of the two BatchedEnvs on the same state: lo within 1 level on at
# most 0.1% of the channel values (AA coverage rounding); hi, whose fills
# have hard edges, on at most 0.1% of them (the ego camera allowance of
# tests/test_torch_render.py).  The JAX BatchedEnv renders inside one jit,
# where XLA fuses and rounds some pixels apart from the same render run op
# by op (which the port's plain render equals byte for byte: test_torch_
# render_families.py); on a MatchRegions Demo reset one allo pixel moves by
# 37 levels.  So lo values may also be further apart on at most 2e-4 of
# them.  Poses after a few steps: float32 rounding.  The first steps from
# a reset are chaotic in the reference itself (a finger starts at its
# joint limit), so each bound is at least twice the largest divergence of
# the reference's own runs from 1-ulp nudged states (`nudges`).
SLICE_LO_MAX_LEVELS = 1
SLICE_MAX_SHARE = 1e-3
SLICE_FUSED_SHARE = 2e-4
SLICE_POSE_ATOL = 1e-4


def _frame_diffs(jo, to):
    """(share of values that differ, share more than a level apart)."""
    if isinstance(jo, dict):
        assert set(jo) == set(to)
        parts = [_frame_diffs(jo[v], to[v]) for v in jo]
        return tuple(max(p[i] for p in parts) for i in (0, 1))
    a = np.asarray(jo).astype(int)
    b = (to.numpy() if isinstance(to, torch.Tensor) else np.asarray(to)) \
        .astype(int)
    assert a.shape == b.shape
    if isinstance(to, torch.Tensor):
        assert to.dtype == torch.uint8
    d = np.abs(a - b)
    return float((d > 0).mean()), float((d > SLICE_LO_MAX_LEVELS).mean())


def assert_frames_close(jo, to, fidelity, chaos=()):
    """JAX observation `jo` against the port's `to` (arrays or dicts);
    `chaos`, the JAX observations of 1-ulp-nudged runs, widen the bounds
    to twice their largest divergence."""
    share, far = _frame_diffs(jo, to)
    c_share, c_far = (max(x) for x in zip(
        (0.0, 0.0), *(_frame_diffs(jo, c) for c in chaos)))
    if fidelity == 'lo':
        assert far <= max(SLICE_FUSED_SHARE, 2 * c_far), far
    assert share <= max(SLICE_MAX_SHARE, 2 * c_share), share


def slice_against_the_reference(name, fidelity, n_steps=3, batch=2):
    """BatchedEnv `name` of the port against the JAX package's on the
    CPU (XLA path), from the JAX reset converted: the observations of the
    reset and of `n_steps` steps, `done`, the reward and, at the last
    step, which the step counters are set to reach, `eval_score`."""
    from magical_tpu.api.batched_env import BatchedEnv as JaxEnv
    from magical_tpu_torch.api.batched_env import BatchedEnv, EnvCarry
    from magical_tpu_torch.core import preproc

    je = JaxEnv(name, fidelity=fidelity)
    te = BatchedEnv(name, fidelity=fidelity, device='cpu')
    jc, jo = je.reset(jax.random.split(jax.random.PRNGKey(0), batch))
    t0 = te.max_episode_steps - n_steps
    jc = jc.replace(state=jc.state.replace(
        t=jnp.full((batch,), t0, jnp.int32)))
    nudged = [jc.replace(state=n) for n in nudges(jc.state)]
    state = jax_to_torch(jc.state)
    raw = te.render_views(state, te.preproc.res, te.preproc.views)
    if te.preproc.raw:
        tc, to = EnvCarry(state=state, frames={}, t=t0), raw
    else:
        # the reset fills every slot of the ring with the reset frame, so
        # its phase is free
        frames = preproc.init_frames_cf(te.preproc, raw)
        tc = EnvCarry(state=state, frames=frames, t=t0)
        to = preproc.observation_cf(te.preproc, frames, t0, te.preproc.res)
    assert_frames_close(jo, to, fidelity)
    acts = np.array([A['UpOpen'], A['RightClose']] * batch, np.int32)[:batch]
    for k in range(n_steps):
        jc, jo, jr, jd, ji = je.step(jc, jnp.asarray(acts))
        runs = [je.step(n, jnp.asarray(acts)) for n in nudged]
        nudged = [r[0] for r in runs]
        tc, to, tr, td, ti = te.step(tc, torch.from_numpy(acts))
        assert_frames_close(jo, to, fidelity, chaos=[r[1] for r in runs])
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        # the score of each env: the reference's, or that of a nudged run
        got = ti['eval_score'].numpy()
        assert np.any([np.abs(got - np.asarray(i['eval_score'])) <= 1e-6
                       for i in [ji] + [r[4] for r in runs]], 0).all()
    assert td.all() and tc.t == te.max_episode_steps
    jn, tn = jax_to_numpy(jc.state), torch_to_numpy(tc.state)
    for f in ('pos', 'angle'):
        tol = max([SLICE_POSE_ATOL] + [2 * max_abs(getattr(n.state, f), jn[f])
                                       for n in nudged])
        np.testing.assert_allclose(tn[f], jn[f], rtol=0, atol=tol,
                                   err_msg=f)
    return te, tc, ti


# ---------------------------------------------------------------------------
# The random numbers a JAX reset draws, by the names of the port's draws
# ---------------------------------------------------------------------------

def _placement(out, name, key):
    """place_entity's proposals from `key` (randomize.py:193-199)."""
    kp, kr = jax.random.split(key)
    out[f'{name}/pos'] = jax.random.uniform(kp, (JR.N_TRIES, 2))
    out[f'{name}/ang'] = jax.random.uniform(kr, (JR.N_TRIES,))


def _choice(key, values, shape=()):
    """The index base.choice draws from `key`."""
    return jax.random.randint(key, shape, 0, len(values))


def _draws_fix_colour(key, f):
    ks = jax.random.split(key, 12)
    out = {}
    if f.dynamics:
        out['phys'] = jax.random.uniform(ks[0], (JC.N_PHYS_VARS,))
    n = 3
    if f.count:
        n = out['count'] = jax.random.randint(ks[1], (), 2, 4)
    if f.colour:
        out['region_colours'] = _choice(ks[2], JC.RAND_SHAPE_COLOURS, (3,))
        out['odd_idx'] = jax.random.randint(ks[3], (), 0, n)
        out['new_col_idx'] = jax.random.randint(ks[4], (), 0, 3)
    if f.shape:
        out['shapes'] = _choice(ks[5], JC.RAND_SHAPE_TYPES, (3,))
    if f.layout_minor or f.layout_full:
        for i, k in enumerate(jax.random.split(ks[6], 3)):
            out[f'goal_hw{i}'] = jax.random.uniform(k, (2,))
        for i, k in enumerate(jax.random.split(ks[7], 3)):
            _placement(out, f'goal{i}', k)
        _placement(out, 'robot', ks[8])
        for i, k in enumerate(jax.random.split(ks[9], 3)):
            _placement(out, f'block{i}', k)
    return out


def _draws_make_line(key, f):
    ks = jax.random.split(key, 6)
    out = {}
    if f.dynamics:
        out['phys'] = jax.random.uniform(ks[0], (JC.N_PHYS_VARS,))
    if f.count:
        out['count'] = jax.random.randint(ks[1], (), 3, 5)
    if f.colour:
        out['colours'] = _choice(ks[2], JC.RAND_SHAPE_COLOURS, (4,))
    if f.shape:
        out['shapes'] = _choice(ks[3], JC.RAND_SHAPE_TYPES, (4,))
    if f.layout_minor or f.layout_full:
        _placement(out, 'robot', ks[4])
        for i, k in enumerate(jax.random.split(ks[5], 4)):
            _placement(out, f'block{i}', k)
    return out


def _draws_find_dupe(key, f):
    ks = jax.random.split(key, 12)
    out = {}
    if f.dynamics:
        out['phys'] = jax.random.uniform(ks[0], (JC.N_PHYS_VARS,))
    if f.count:
        out['count'] = jax.random.randint(ks[1], (), 1, 6)
    if f.colour:
        out['query_colour'] = _choice(ks[2], JC.RAND_SHAPE_COLOURS)
        out['colours'] = _choice(ks[3], JC.RAND_SHAPE_COLOURS, (7,))
    if f.shape:
        out['query_shape'] = _choice(ks[4], JC.RAND_SHAPE_TYPES)
        out['shapes'] = _choice(ks[5], JC.RAND_SHAPE_TYPES, (7,))
    if f.layout_minor or f.layout_full:
        out['goal_hw'] = jax.random.uniform(ks[6], (2,))
        _placement(out, 'goal', ks[7])
        _placement(out, 'robot', ks[8])
        for i, k in enumerate(jax.random.split(ks[9], 6)):
            _placement(out, f'block{i}', k)
        _placement(out, 'query', ks[10])
    return out


def _draws_match_regions(key, f):
    ks = jax.random.split(key, 10)
    out = {}
    if f.dynamics:
        out['phys'] = jax.random.uniform(ks[0], (JC.N_PHYS_VARS,))
    if f.colour:
        out['target_colour'] = _choice(ks[1], JC.RAND_SHAPE_COLOURS)
    if f.layout_minor or f.layout_full:
        out['goal_hw'] = jax.random.uniform(ks[2], (2,))
    if f.count:
        out['target_count'] = jax.random.randint(ks[3], (), 1, 3)
        out['distractor_counts'] = jax.random.randint(ks[4], (3,), 0, 3)
    if f.shape:
        out['shapes'] = _choice(ks[5], JC.RAND_SHAPE_TYPES, (8,))
    if f.layout_minor or f.layout_full:
        _placement(out, 'goal', ks[6])
        _placement(out, 'robot', ks[7])
        for i, k in enumerate(jax.random.split(ks[8], 8)):
            _placement(out, f'block{i}', k)
    return out


def _draws_cluster(key, f):
    ks = jax.random.split(key, 6)
    out = {}
    if f.dynamics:
        out['phys'] = jax.random.uniform(ks[0], (JC.N_PHYS_VARS,))
    if f.count:
        out['count'] = jax.random.randint(ks[1], (), 7, 11)
    for name, k, values, on in (('colours', ks[2], JC.RAND_SHAPE_COLOURS,
                                 f.colour),
                                ('shapes', ks[3], JC.RAND_SHAPE_TYPES,
                                 f.shape)):
        if on:
            k1, k2 = jax.random.split(k)
            out[f'{name}/fill'] = _choice(k1, values, (10,))
            out[f'{name}/perm'] = jax.random.uniform(k2, (10,))
    if f.layout_minor or f.layout_full:
        _placement(out, 'robot', ks[4])
        for i, k in enumerate(jax.random.split(ks[5], 10)):
            _placement(out, f'block{i}', k)
    return out


_DRAWS = {'FixColour': _draws_fix_colour, 'MakeLine': _draws_make_line,
          'FindDupe': _draws_find_dupe, 'MatchRegions': _draws_match_regions,
          'ClusterColour': _draws_cluster, 'ClusterShape': _draws_cluster}


def jax_draws(task, variant, keys):
    """{draw name: (B, ...) numpy} of the random numbers that
    `task`'s JAX reset draws from each of `keys`, under the names of the
    port's draws (magical_tpu_torch.tasks.base.Draws)."""
    f = JAX_TASKS[task].flags_for(variant)
    out = jax.jit(jax.vmap(lambda k: _DRAWS[task](k, f)))(keys)
    return {k: np.asarray(v) for k, v in out.items()}
