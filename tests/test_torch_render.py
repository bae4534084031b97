"""magical_tpu_torch's renderer and frame rings against magical_tpu's XLA
reference, on identical states (JAX states carried over as numpy)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magical_tpu.core import physics as JP
from magical_tpu.core import preproc as JPre
from magical_tpu.core import render as JR
from magical_tpu.tasks import ALL_TASKS as JT
from magical_tpu_torch.core import preproc as TPre
from magical_tpu_torch.core import render as TR
from magical_tpu_torch.core import render_kernel as TRK

from _torch_port import jax_demo_states, jax_to_torch

B = 4
TASK = JT['MoveToCorner']
SS = TASK.static_block_shapes(TASK.flags_for('Demo'))
# Lo fidelity: AA coverage is a continuous function of the pose; float32
# rounding differences (XLA contracts to FMA) flip a value across a
# quantisation boundary now and then: at most 1 level, on at most 0.1% of
# the channel values.
LO_MAX_LEVELS = 1
LO_MAX_SHARE = 1e-3


def _states(goal=False):
    """B MoveToCorner-Demo states after 3 random steps; with `goal`, the
    (normally inactive) goal slot is activated with random boxes so that
    the stippled outline is drawn too."""
    js = jax_demo_states(B)
    rng = np.random.default_rng(0)
    step = jax.jit(jax.vmap(JP.control_step))
    for _ in range(3):
        js = step(js, jnp.asarray(rng.integers(0, 18, B).astype(np.int32)))
    if goal:
        xyhw = np.stack([rng.uniform(-0.6, 0.2, B), rng.uniform(-0.2, 0.6, B),
                         rng.uniform(0.4, 0.8, B), rng.uniform(0.4, 0.8, B)],
                        -1).astype(np.float32)[:, None]
        js = js.replace(goal_xyhw=jnp.asarray(xyhw),
                        goal_colour=jnp.full((B, 1), 2, jnp.int32),
                        goal_active=jnp.ones((B, 1), bool))
    return js, jax_to_torch(js)


@functools.lru_cache(maxsize=None)
def _jax_render(fidelity):
    return jax.jit(jax.vmap(functools.partial(
        JR.render_views, max_blocks=1, max_goals=1, robot_first=True,
        views=('allo', 'ego'), fidelity=fidelity, static_shapes=SS)))


def _jax_views(js, fidelity):
    return _jax_render(fidelity)(js)


def test_display_list_matches():
    js, ts = _states(goal=True)
    dj = jax.jit(jax.vmap(lambda s: JR.build_display_list(
        s, 1, 1, True, static_shapes=SS)))(js)
    dt = TR.build_display_list(ts, 1, 1, True, static_shapes=SS)
    assert dj.keys() == dt.keys()
    for k in dj:
        a, b = np.asarray(dj[k]), dt[k].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k == 'verts':
            # rotated verts: float32 rounding of the 2x2 transform
            np.testing.assert_allclose(b, a, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize('goal', [False, True], ids=['demo', 'goal'])
def test_render_views_lo_within_one_level(goal):
    js, ts = _states(goal)
    j = _jax_views(js, 'lo')
    t = TR.render_views(ts, 1, 1, True, views=('allo', 'ego'),
                        fidelity='lo', static_shapes=SS)
    for v in ('allo', 'ego'):
        a = np.asarray(j[v]).astype(int)
        b = t[v].numpy().astype(int)
        assert a.shape == b.shape == (B, 96, 96, 3)
        d = np.abs(a - b)
        assert d.max() <= LO_MAX_LEVELS, v
        assert (d > 0).mean() <= LO_MAX_SHARE, v


def test_render_views_hi_byte_equal():
    js, ts = _states()
    j = _jax_views(js, 'hi')
    t = TR.render_views(ts, 1, 1, True, views=('allo', 'ego'),
                        fidelity='hi', static_shapes=SS)
    for v in ('allo', 'ego'):
        np.testing.assert_array_equal(t[v].numpy(), np.asarray(j[v]),
                                      err_msg=v)


def test_render_kernel_wrappers_take_plain_path_on_cpu():
    _, ts = _states()
    TRK.render_views_lo.launches = 0
    TRK.render_into_slots.launches = 0
    plain = TR.render_views(ts, 1, 1, True, views=('allo', 'ego'),
                            fidelity='lo', static_shapes=SS)
    fresh = TRK.render_views_lo(ts, 1, 1, True, views=('allo', 'ego'),
                                static_shapes=SS)
    spec = TPre.PREPROCESSORS['LoRes3EA']
    rings = {v: torch.zeros((spec.depth(v), B, 96, 96, 3), dtype=torch.uint8)
             for v in spec.views}
    TRK.render_into_slots(ts, rings, 5, 1, 1, True, spec, static_shapes=SS)
    assert TRK.render_views_lo.launches == 0
    assert TRK.render_into_slots.launches == 0
    for v in ('allo', 'ego'):
        assert torch.equal(fresh[v], plain[v])
        slot = 5 % spec.depth(v)
        assert torch.equal(rings[v][slot], plain[v])
        others = [k for k in range(spec.depth(v)) if k != slot]
        assert all(int(rings[v][k].max()) == 0 for k in others)


@pytest.mark.parametrize('name', list(JPre.PREPROCESSORS))
def test_frame_rings_give_the_reference_observation(name):
    """Same frames in, the same observation bytes out: the port's
    (depth, B, H, W, 3) rings against the reference's rolling NHWC
    buffers, over more pushes than the stack is deep."""
    jspec, tspec = JPre.PREPROCESSORS[name], TPre.PREPROCESSORS[name]
    rng = np.random.default_rng(0)

    def frames():
        return {v: rng.integers(0, 256, (B, 8, 8, 3), dtype=np.uint8)
                for v in jspec.views}

    f0 = frames()
    jb = jax.vmap(functools.partial(JPre.init_frames, jspec))(f0)
    tb = TPre.init_frames_cf(tspec, {v: torch.from_numpy(x)
                                     for v, x in f0.items()})

    def check(jbufs, tbufs, t, raw):
        jo = jax.vmap(functools.partial(JPre.observation, jspec))(jbufs, raw)
        to = TPre.observation_cf(tspec, tbufs, t, 8)
        if isinstance(jo, dict):
            assert jo.keys() == to.keys()
            for v in jo:
                np.testing.assert_array_equal(to[v].numpy(),
                                              np.asarray(jo[v]))
        else:
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))

    check(jb, tb, 0, f0)
    for t in range(1, 7):
        f = frames()
        jb = jax.vmap(functools.partial(JPre.push_frames, jspec))(jb, f)
        tb = TPre.push_frames_cf(tspec, tb, {v: torch.from_numpy(x)
                                             for v, x in f.items()}, t)
        check(jb, tb, t, f)
