"""magical_tpu_torch's renderer on the multi-block families' TestAll states
(up to three goal regions, up to 138 display prims) against magical_tpu's
XLA reference, and the 2-D tiled lo render (K5) on the CPU."""

import jax
import numpy as np
import pytest
import torch

from magical_tpu.core import render as JR
from magical_tpu.tasks import ALL_TASKS as JT
from magical_tpu_torch.core import render as TR
from magical_tpu_torch.core import render_kernel as TRK
from magical_tpu_torch.tasks import ALL_TASKS as TT

from _torch_port import FAMILIES, jax_resets, jax_to_torch
from test_torch_render import (HI_MAX_LEVELS, HI_MAX_SHARE, LO_MAX_LEVELS,
                               LO_MAX_SHARE)

B = 2


def _jax_views(task, js, fidelity):
    """JAX's render_views of each env, run op by op: at 100+ prims that is
    seconds, where compiling the batched render takes minutes on the
    CPU."""
    t = JT[task]
    frames = [JR.render_views(
        jax.tree_util.tree_map(lambda x: x[b], js),
        max_blocks=t.max_blocks, max_goals=t.max_goals, robot_first=False,
        res=96, views=('allo', 'ego'), fidelity=fidelity,
        static_shapes=t.static_block_shapes(t.flags_for('TestAll')))
        for b in range(B)]
    return {v: np.stack([np.asarray(f[v]) for f in frames])
            for v in ('allo', 'ego')}


def _scene(task):
    t = TT[task]
    return (t.max_blocks, t.max_goals, False)


def _states(task):
    js = jax_resets(task, 'TestAll', B, 2)
    return js, jax_to_torch(js)


@pytest.mark.parametrize('task', FAMILIES)
def test_display_list_and_lo_render_equal_the_reference(task):
    js, ts = _states(task)
    t = JT[task]
    dj = jax.jit(jax.vmap(lambda s: JR.build_display_list(
        s, t.max_blocks, t.max_goals, False)))(js)
    dt = TR.build_display_list(ts, *_scene(task))
    assert dj.keys() == dt.keys()
    for k in dj:
        a, b = np.asarray(dj[k]), dt[k].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k == 'verts':
            # rotated verts: float32 rounding of the 2x2 transform
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    j = _jax_views(task, js, 'lo')
    tv = TR.render_views(ts, *_scene(task), views=('allo', 'ego'),
                         fidelity='lo')
    np.testing.assert_array_equal(tv['allo'].numpy(), j['allo'])
    # XLA computes the ego camera's rotation 1 ulp apart from the port on
    # about half the pixel centres (ROADMAP.md, "Faults found"), which
    # now and then moves an AA value across a quantisation boundary
    d = np.abs(tv['ego'].numpy().astype(int) - j['ego'].astype(int))
    assert d.max() <= LO_MAX_LEVELS
    assert (d > 0).mean() <= LO_MAX_SHARE


@pytest.mark.parametrize('task', ['FixColour', 'ClusterColour'])
def test_hi_render_within_the_ego_camera_allowance(task):
    """Hard fill edges: one subpixel that XLA's ego camera rounds to the
    other side moves a value by up to 16 levels (tests/test_torch_render.py);
    FixColour for its three goal regions, ClusterColour for its 138
    prims."""
    js, ts = _states(task)
    j = _jax_views(task, js, 'hi')
    tv = TR.render_views(ts, *_scene(task), views=('allo', 'ego'),
                         fidelity='hi')
    for v in ('allo', 'ego'):
        d = np.abs(tv[v].numpy().astype(int) - np.asarray(j[v]).astype(int))
        assert d.max() <= HI_MAX_LEVELS, v
        assert (d > 0).mean() <= HI_MAX_SHARE, v


@pytest.mark.parametrize('tiles2d', [(16, 16), (32, 32), (8, 32)])
def test_tiles2d_on_the_cpu_is_the_plain_lo_render(tiles2d):
    _, ts = _states('ClusterColour')
    TRK.render_lo_tiles2d.launches = 0
    got = TRK.render_views_lo(ts, *_scene('ClusterColour'), tiles2d=tiles2d)
    want = TR.render_views(ts, *_scene('ClusterColour'), fidelity='lo')
    for v in ('allo', 'ego'):
        assert torch.equal(got[v], want[v])
    assert TRK.render_lo_tiles2d.launches == 0


@pytest.mark.parametrize('tiles2d', [(7, 16), (16, 0), (96, 40), (-16, 16)])
def test_tiles2d_must_divide_res(tiles2d):
    _, ts = _states('FixColour')
    with pytest.raises(ValueError, match='divide'):
        TRK.render_views_lo(ts, *_scene('FixColour'), tiles2d=tiles2d)


def test_prim_screen_boxes_bound_every_coloured_pixel():
    """K5's cull, plain: a prim outside its screen box has alpha exactly 0.
    Each prim is drawn alone, on random poses of every block shape, at lo
    fidelity at 96² and 384², and no pixel it colours lies outside its
    box."""
    _, ts = _states('ClusterShape')
    rng = np.random.default_rng(0)
    ts.pos = ts.pos + torch.from_numpy(
        rng.normal(0.0, 0.05, ts.pos.shape).astype(np.float32))
    ts.angle = torch.from_numpy(
        rng.uniform(-np.pi, np.pi, ts.angle.shape).astype(np.float32))
    disp = TRK.kernel_display(ts, *_scene('ClusterShape'))
    for view, res in (('allo', 96), ('ego', 96), ('ego', 384)):
        bb, bounded = TRK.prim_screen_bboxes(disp, ts, view, res)
        pix, scale = (TR.allo_pixel_coords(res, 'cpu') if view == 'allo'
                      else TR.ego_pixel_coords(ts, res))
        u = torch.arange(res, dtype=torch.float32) + 0.5
        n_checked = 0
        for p in range(disp['nv'].shape[1]):
            if not bool(disp['active'][:, p].any()):
                continue
            one = {k: x[:, p:p + 1] if x.dim() > 1
                   else x[p:p + 1].expand(B, 1) for k, x in disp.items()}
            img = TR.render_frame(one, pix, scale, res, aa=True)
            bg = torch.tensor(TR.C.BACKGROUND_COLOUR, dtype=torch.float32)
            drawn = (img != bg).any(-1) & disp['active'][:, p, None, None]
            inside = ((u[None, None, :] >= bb[:, p, 0, None, None])
                      & (u[None, None, :] <= bb[:, p, 1, None, None])
                      & (u[None, :, None] >= bb[:, p, 2, None, None])
                      & (u[None, :, None] <= bb[:, p, 3, None, None]))
            inside |= ~bounded[:, p, None, None]
            assert not bool((drawn & ~inside).any()), (view, res, p)
            n_checked += int(drawn.any(-1).any(-1).sum())
        assert n_checked > 50


@pytest.mark.parametrize('task,view', [('FixColour', 'allo'),
                                       ('ClusterShape', 'ego')])
def test_prim_screen_boxes_bound_every_coloured_subpixel(task, view):
    """K4's cull, plain: on the 4x grid of the hi render, a prim outside
    its screen box (prim_screen_bboxes at 4 * res) has coverage exactly 0.
    Each prim is drawn alone with hard fills, outline bands and stipples,
    as render_views(fidelity='hi') draws it before the 4x4 mean, on
    TestAll states moved and turned at random (FixColour's three goal
    regions, ClusterShape's every block shape), and no subpixel it colours
    lies outside its box."""
    _, ts = _states(task)
    rng = np.random.default_rng(1)
    ts.pos = ts.pos + torch.from_numpy(
        rng.normal(0.0, 0.05, ts.pos.shape).astype(np.float32))
    ts.angle = torch.from_numpy(
        rng.uniform(-np.pi, np.pi, ts.angle.shape).astype(np.float32))
    disp = TRK.kernel_display(ts, *_scene(task))
    n = 4 * 96
    bg = torch.tensor(TR.C.BACKGROUND_COLOUR, dtype=torch.float32)
    u = torch.arange(n, dtype=torch.float32) + 0.5
    bb, bounded = TRK.prim_screen_bboxes(disp, ts, view, n)
    pix, scale = (TR.allo_pixel_coords(n, 'cpu') if view == 'allo'
                  else TR.ego_pixel_coords(ts, n))
    n_checked = 0
    for p in range(disp['nv'].shape[1]):
        if not bool(disp['active'][:, p].any()):
            continue
        one = {k: x[:, p:p + 1] if x.dim() > 1
               else x[p:p + 1].expand(B, 1) for k, x in disp.items()}
        img = TR.render_frame(one, pix, scale, n, aa=False)
        drawn = (img != bg).any(-1) & disp['active'][:, p, None, None]
        inside = ((u[None, None, :] >= bb[:, p, 0, None, None])
                  & (u[None, None, :] <= bb[:, p, 1, None, None])
                  & (u[None, :, None] >= bb[:, p, 2, None, None])
                  & (u[None, :, None] <= bb[:, p, 3, None, None]))
        inside |= ~bounded[:, p, None, None]
        assert not bool((drawn & ~inside).any()), p
        n_checked += int(drawn.any(-1).any(-1).sum())
    assert n_checked > 50
    assert bool((disp['kind'] == TR.KIND_LINE_STIPPLE).any())
