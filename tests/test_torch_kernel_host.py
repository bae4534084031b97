"""The CUDA kernels' own arithmetic, built for the host, against their plain
PyTorch versions.

A CUDA kernel cannot run without the card, but the per-env physics and
per-pixel compositing of ``magical_tpu_torch/csrc`` live in
``__host__ __device__`` functions (``*.cuh``).  ``kernel_host_shim.cpp``
loops them over the batch; it is built here with the host C++ compiler,
with FMA contraction off, and called with the same tables and arguments
the CUDA wrappers pass.  The control step's narrowphase cull is held
against a full test of every item, and its margin against an adversarial
sweep of slot pairs.  The kernels on the card are held against the same
plain versions by ``chip_smoke.py``.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch import geometry as G
from magical_tpu_torch.core import collision, physics, physics_kernel
from magical_tpu_torch.core import render
from magical_tpu_torch.core import render_kernel
from magical_tpu_torch.tasks import ALL_TASKS

import _kernel_host
from _torch_port import seek_block_actions

TASK = ALL_TASKS['MoveToCorner']
SS = TASK.static_block_shapes(TASK.flags_for('Demo'))


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    lib = _kernel_host.build(tmp_path_factory.mktemp('kernel_host'))
    if lib is None:
        pytest.skip('no host C++ compiler to build the kernel sources')
    return lib


def _rollout(B, n_steps, seed):
    """Plain states along a seeded rollout from reset, with the actions
    taken from each: three envs in four drive into the block
    (`seek_block_actions`), the fourth acts at random."""
    st = TASK.reset_fn(torch.Generator().manual_seed(seed), B,
                       TASK.flags_for('Demo'), 'cpu')
    acts = seek_block_actions(B, n_steps)
    rng = np.random.default_rng(seed)
    acts[:, 3::4] = rng.integers(0, 18, acts[:, 3::4].shape)
    out = []
    for i in range(n_steps):
        a = torch.from_numpy(np.ascontiguousarray(acts[i]))
        out.append((st, a))
        st = physics.control_step(st, a)
    return out


def _kernel_step(host_lib, st, a, ftab, itab, phys_steps):
    sk = st.clone()
    physics_kernel.check_inputs(sk, a)
    rc = host_lib.physics_control_step(
        *physics_kernel.kernel_args(sk, a, ftab, itab, phys_steps=phys_steps),
        None)
    assert rc == 0
    return sk


FIELDS = ('vel', 'omega', 'con_jn', 'con_jt', 'joint_acc')
# One substep: the two differ only where the host's sinf/cosf round apart
# from PyTorch's in the last ulp (measured at most 2e-5, on a finger
# velocity); positions integrate from the same inputs and are equal.
SUBSTEP_ATOL = 1e-4
# One control step (10 substeps x 10 sweeps): those ulps grow in the envs
# where the solver is chaotic (the stiff finger pin joints, contacts), but
# the median env stays within 1e-6 in every field (measured <= 6e-7).
STEP_MEDIAN_ATOL = 1e-6


def test_physics_kernel_arithmetic_matches_plain(host_lib):
    ftab, itab, layout = physics_kernel.table_arrays(1)
    got = (ctypes.c_int * 3)()
    host_lib.physics_table_layout(got)
    assert tuple(got) == layout
    ftab, itab = torch.from_numpy(ftab), torch.from_numpy(itab)
    n_contact = 0
    for st, a in _rollout(64, 12, 0):
        sk = _kernel_step(host_lib, st, a, ftab, itab, 1)
        sp = physics.control_step(st, a, phys_steps=1)
        assert torch.equal(sk.pos, sp.pos) and torch.equal(sk.angle, sp.angle)
        for f in FIELDS:
            assert float((getattr(sk, f) - getattr(sp, f)).abs().max()) \
                <= SUBSTEP_ATOL, f
        assert torch.equal(sk.con_id, sp.con_id)

        sk = _kernel_step(host_lib, st, a, ftab, itab, C.PHYS_STEPS)
        sp = physics.control_step(st, a)
        for f in ('pos', 'angle') + FIELDS:
            err = (getattr(sk, f) - getattr(sp, f)).abs() \
                .reshape(st.batch, -1).amax(1)
            assert float(err.median()) <= STEP_MEDIAN_ATOL, f
        assert torch.equal(sk.con_id, sp.con_id)
        assert torch.equal(sk.t, sp.t)
        for f in ('target_speed', 'rel_turn_angle', 'target_finger_angle'):
            assert torch.equal(getattr(sk, f), getattr(sp, f)), f
        n_contact += int((sp.con_id >= 0).any(1).sum())
    assert n_contact > 0


_torch_trig = _kernel_host.torch_trig
_scene_args = _kernel_host.scene_args


def _scene_frame(host_lib, st, scene, ss, view, res=96,
                 tile=render_kernel.LO_TILE, entry='render_lo_frame'):
    """The frame of `st` through kernel entry point `entry` (K2/K3, K4 or
    K5), built for the host from the display program of `scene` =
    (max_blocks, max_goals, robot_first), over `tile`."""
    prog = render_kernel.program_arrays(*scene, ss)
    out = torch.empty((st.batch, res, res, 3), dtype=torch.uint8)
    keep = _torch_trig(host_lib, st)
    fields, args = _scene_args(st, prog, out, res, view,
                               render_kernel._ENTRIES[entry][0])
    assert getattr(host_lib, entry)(*args, *tile, None) == 0
    assert host_lib.render_trig_misses() == 0
    del keep, fields
    return out


@pytest.mark.parametrize('view', ['allo', 'ego'])
def test_render_kernel_arithmetic_matches_plain(host_lib, view):
    """K2/K3, built for the host: the display list built from the state,
    culled by tiles and composited, byte-equal to the plain lo render
    (MoveToCorner-Demo with an active goal for the stippled outline), for
    the kernels' tiles, smaller and ragged ones, and one tile a frame."""
    st, _ = _rollout(8, 4, 3)[-1]
    st.goal_active[:, 0] = True
    st.goal_xyhw[:, 0] = torch.tensor([-0.4, 0.3, 0.6, 0.5])
    plain = render.render_views(st, 1, 1, True, views=(view,),
                                fidelity='lo', static_shapes=SS)[view]
    for tile in (render_kernel.LO_TILE, (16, 16), (40, 28), (96, 96)):
        out = _scene_frame(host_lib, st, (1, 1, True), SS, view, tile=tile)
        # same operations in the same order, rounded one by one
        assert torch.equal(out, plain), tile
    assert np.unique(plain.numpy()).size > 20


FAMILIES8 = ['MoveToCorner', 'MoveToRegion', 'FixColour', 'MakeLine',
             'FindDupe', 'MatchRegions', 'ClusterColour', 'ClusterShape']


def _family_scene(task, variant, seed, B=4):
    """A `variant` reset of `task`, every body moved and turned at
    random, with its scene (max_blocks, max_goals, robot_first) and static
    block shapes."""
    t = ALL_TASKS[task]
    flags = t.flags_for(variant)
    st = t.reset_fn(torch.Generator().manual_seed(seed), B, flags, 'cpu')
    rng = np.random.default_rng(seed)
    st.pos += torch.from_numpy(rng.normal(0.0, 0.1, st.pos.shape)
                               .astype(np.float32))
    st.angle = torch.from_numpy(rng.uniform(-np.pi, np.pi, st.angle.shape)
                                .astype(np.float32))
    return st, (t.max_blocks, t.max_goals, task == 'MoveToCorner'), \
        t.static_block_shapes(flags)


@pytest.mark.parametrize('task', FAMILIES8)
def test_build_prim_matches_build_display_list(host_lib, task):
    """build_prim (csrc/render_lo.cuh), built for the host, from the state
    and the display program: field by field equal to the plain
    build_display_list on a Demo and a TestAll state of every family."""
    got = (ctypes.c_int * 4)()
    host_lib.render_program_layout(got)
    for variant, seed in (('Demo', 1), ('TestAll', 2)):
        st, scene, ss = _family_scene(task, variant, seed)
        prog = render_kernel.program_arrays(*scene, ss)
        assert tuple(got) == (render_kernel.PROG_I, render_kernel.PROG_F,
                              prog[2].size, prog[3].size)
        want = render.build_display_list(st, *scene, static_shapes=ss)
        B, P = st.batch, prog[0].shape[0]
        assert want['nv'].shape == (B, P)
        out = dict(verts=torch.empty((B, P, render.NV, 2)),
                   nv=torch.empty((B, P), dtype=torch.int32),
                   radius=torch.empty((B, P)), color=torch.empty((B, P, 3)),
                   active=torch.empty((B, P), dtype=torch.int32))
        keep = _torch_trig(host_lib, st)
        frame = torch.empty((B, 96, 96, 3), dtype=torch.uint8)
        fields, args = _scene_args(st, prog, frame, 96, 'ego')
        assert host_lib.render_build_display(
            *args, *render_kernel.LO_TILE,
            *(out[k].data_ptr() for k in ('verts', 'nv', 'radius', 'color',
                                          'active'))) == 0
        assert host_lib.render_trig_misses() == 0
        del keep, fields
        for k in ('verts', 'nv', 'radius', 'color'):
            assert torch.equal(out[k], want[k]), (variant, k)
        assert torch.equal(out['active'].bool(), want['active']), variant
        assert bool(want['active'].any(1).all())


@pytest.mark.parametrize('task,variant', [('MoveToCorner', 'Demo'),
                                          ('ClusterColour', 'TestAll')])
@pytest.mark.parametrize('view', ['allo', 'ego'])
def test_scene_render_matches_plain(host_lib, task, variant, view):
    """K2/K3 from the state, built for the host, byte-equal to the plain
    lo render: the main path's scene (20 prims) and the widest (138)."""
    st, scene, ss = _family_scene(task, variant, 3, B=3)
    plain = render.render_views(st, *scene, views=(view,), fidelity='lo',
                                static_shapes=ss)[view]
    assert torch.equal(_scene_frame(host_lib, st, scene, ss, view), plain)


# K4's tilings in the host tests: the kernel's own, a smaller one, a ragged
# one and one tile a frame.
HI_TILES = (render_kernel.HI_TILE, (8, 8), (40, 28), (96, 96))


@pytest.mark.parametrize('view', ['allo', 'ego'])
def test_hi_render_kernel_arithmetic_matches_plain(host_lib, view):
    """K4, built for the host: the display list built from the state,
    culled by tiles of the 4x grid and by subpixel row, then the subpixel
    compositing and 4x4 box mean, on every block shape a Test variant
    draws and an active goal (light fill + stippled border), byte-equal to
    the plain hi render for every tiling of HI_TILES."""
    st, _ = _rollout(4, 4, 5)[-1]
    st.block_shape[:, 0] = torch.tensor(C.RAND_SHAPE_TYPES, dtype=torch.int32)
    st.goal_active[:, 0] = True
    st.goal_xyhw[:, 0] = torch.tensor([-0.3, 0.2, 0.7, 0.6])
    st.goal_colour[:, 0] = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    plain = render.render_views(st, 1, 1, True, views=(view,),
                                fidelity='hi', static_shapes=None)[view]
    for tile in HI_TILES:
        out = _scene_frame(host_lib, st, (1, 1, True), None, view, tile=tile,
                           entry='render_hi_frame')
        # hard edges: one subpixel rounding the other way would move a
        # value by up to 16 levels; the same operations in the same order
        # leave none
        assert torch.equal(out, plain), tile
    assert np.unique(plain.numpy()).size > 20


@pytest.mark.parametrize('task,B,res,tiles', [
    ('ClusterColour', 2, 96, (render_kernel.HI_TILE, (40, 28))),
    ('MoveToRegion', 1, 384, (render_kernel.HI_TILE, (40, 28)))])
@pytest.mark.parametrize('view', ['allo', 'ego'])
def test_hi_render_kernel_at_138_prims_and_384(host_lib, task, B, res, tiles,
                                               view):
    """K4 from the state, built for the host, byte-equal to the plain hi
    render at the widest scene (ClusterColour-TestAll, 138 prims) and on a
    raw 384² frame (a 1536² subpixel grid), at the kernel's tile and a
    ragged one."""
    st, scene, ss = _family_scene(task, 'TestAll', 3, B=B)
    plain = render.render_views(st, *scene, res=res, views=(view,),
                                fidelity='hi', static_shapes=ss)[view]
    for tile in tiles:
        out = _scene_frame(host_lib, st, scene, ss, view, res=res, tile=tile,
                           entry='render_hi_frame')
        assert torch.equal(out, plain), tile


def _plain_k4_items(st, scene, ss, view, res=96, tile=render_kernel.HI_TILE,
                    slack=0.0):
    """K4's prim counts (render_kernel.K4_ITEMS) of each env, summed over
    its tiles, from the plain display list and its screen boxes on the 4x
    grid: the active prims from slot 2 up, and those whose box, grown by
    `slack` subpixels on every side, meets a tile's subpixel centres."""
    disp = render_kernel.kernel_display(st, *scene, ss)
    bb, bounded = render_kernel.prim_screen_bboxes(disp, st, view, 4 * res)
    whole = torch.tensor([-1e30, 1e30, -1e30, 1e30])
    u0, u1, w0, w1 = torch.where(bounded[..., None], bb,
                                 whole)[:, 2:].unbind(-1)
    active = disp['active'][:, 2:]
    kept, tiles = 0, 0
    for r0 in range(0, res, tile[0]):
        for c0 in range(0, res, tile[1]):
            rows, cols = min(tile[0], res - r0), min(tile[1], res - c0)
            meets = ~((u1 + slack < 4 * c0 + 0.5)
                      | (u0 - slack > 4 * (c0 + cols) - 0.5)
                      | (w1 + slack < 4 * r0 + 0.5)
                      | (w0 - slack > 4 * (r0 + rows) - 0.5))
            kept = kept + (active & meets).sum(1)
            tiles += 1
    return active.sum(1) * tiles, kept


@pytest.mark.parametrize('task', ['MoveToCorner', 'ClusterColour'])
@pytest.mark.parametrize('view', ['allo', 'ego'])
def test_hi_render_kernel_counts_the_prims_it_culls(host_lib, task, view):
    """K4's step entry, built for the host, with its prim counts: each
    env's active prims from slot 2 up over its tiles, and those whose box
    meets a tile's subpixels, as a plain count from prim_screen_bboxes
    gives them (whose boxes the host's agree with to 1e-3 subpixel, so a
    count is held between the boxes shrunk and grown by that), on
    TestAll states; the frame is the one without the counts."""
    st, scene, ss = _family_scene(task, 'TestAll', 7, B=4)
    prog = render_kernel.program_arrays(*scene, ss)
    plain = _scene_frame(host_lib, st, scene, ss, view, tile=(32, 32),
                         entry='render_hi_frame')
    out = torch.empty_like(plain)
    items = torch.zeros((st.batch, len(render_kernel.K4_ITEMS)),
                        dtype=torch.int64)
    keep = _torch_trig(host_lib, st)
    fields, args = _scene_args(st, prog, out, 96, view, 4)
    assert host_lib.render_hi_into_slot(
        *args, *render_kernel.HI_TILE, None, items.data_ptr(), None,
        None) == 0
    assert host_lib.render_trig_misses() == 0
    del keep, fields
    assert torch.equal(out, plain)
    active, kept = items.unbind(1)
    want_active, want_kept = _plain_k4_items(st, scene, ss, view)
    assert torch.equal(active, want_active)
    _, least = _plain_k4_items(st, scene, ss, view, slack=-1e-3)
    _, most = _plain_k4_items(st, scene, ss, view, slack=1e-3)
    assert bool(((least <= kept) & (kept <= most)).all())
    sure = least == most
    assert int(sure.sum()) >= st.batch - 1
    assert torch.equal(kept[sure], want_kept[sure])
    # the cull keeps fewer than every active prim in every tile, and some
    assert bool((0 < kept).all() and (kept < active).all())


def _plain_k4_pixels(st, scene, ss, view, reach, res=96, slack=0.0):
    """K4's pixel counts (render_kernel.K4_PIXELS) of each env, from the
    plain display list in float64: every pixel, and those with a partial
    prim above their topmost full one, each prim classed at the centre of
    the pixel's 4x4 subpixels within `reach` + `slack` world units, where
    its screen box (prim_screen_bboxes on the 4x grid), grown by 1000 x
    `slack` subpixels, meets them; a box that misses makes a prim none."""
    disp = render_kernel.kernel_display(st, *scene, ss)
    bb, bounded = render_kernel.prim_screen_bboxes(disp, st, view, 4 * res)
    ego, scale, half, npx, npy, lw_scale = (
        float(np.float32(x)) for x in render_kernel.camera_args(view,
                                                                4 * res)[:6])
    q = torch.arange(res, dtype=torch.float64)
    cx = ((4 * q + 2) / scale)[None, None, :]          # (1, 1, col)
    cy = ((4 * q + 2) / scale)[None, :, None]          # (1, row, 1)
    if not ego:
        x, y = (cx - half).expand(st.batch, res, res), \
            (half - cy).expand(st.batch, res, res)
    else:
        c, s = (f(st.angle[:, 0]).double()[:, None, None]
                for f in (torch.cos, torch.sin))
        rx, ry = (st.pos[:, 0, i].double()[:, None, None] for i in (0, 1))
        spx, spy = cx - npx, (4 * res - (4 * q + 2))[None, :, None] / scale \
            - npy
        x, y = c * spx - s * spy + rx, s * spx + c * spy + ry
    v0, _, n, valid = collision._poly_edges(disp['verts'].double(),
                                            disp['nv'])
    offs = (v0 * n).sum(-1)
    reach = reach + slack
    full_at = torch.full((st.batch, res, res), -1)
    classes = []
    for k in range(disp['nv'].shape[1]):
        circle = torch.hypot(x - disp['verts'][:, k, 0, 0].double()[
            :, None, None], y - disp['verts'][:, k, 0, 1].double()[
            :, None, None])
        faces = x[..., None] * n[:, k, None, None, :, 0] \
            + y[..., None] * n[:, k, None, None, :, 1] \
            - offs[:, k, None, None]
        faces = torch.where(valid[:, k, None, None], faces, -1e9)
        d = torch.where((disp['nv'][:, k] == 1)[:, None, None], circle,
                        faces.amax(-1)) - disp['radius'][:, k].double()[
            :, None, None]
        u0, u1, w0, w1 = torch.where(
            bounded[:, k, None], bb[:, k],
            torch.tensor([-1e30, 1e30, -1e30, 1e30])).double()[
            :, None, None].unbind(-1)
        g = 1e3 * slack
        meets = ~((u1 + g < 4 * q[None, None, :] + 0.5)
                  | (u0 - g > 4 * q[None, None, :] + 3.5)
                  | (w1 + g < 4 * q[None, :, None] + 0.5)
                  | (w0 - g > 4 * q[None, :, None] + 3.5)) \
            & disp['active'][:, k, None, None]
        if int(disp['kind'][k]) == render.KIND_FILL:
            full = meets & (d < -reach)
            partial = meets & (d.abs() <= reach)
        else:
            band = max(float(disp['lw'][k]) * lw_scale, 1.0) / (2 * scale) \
                + 0.5 / scale
            full = torch.zeros_like(meets)
            partial = meets & (d.abs() - reach < band)
        full_at = torch.where(full, k, full_at)
        classes.append(partial)
    partial = torch.stack(classes, -1)
    above = torch.arange(len(classes)) > full_at[..., None]
    undecided = (partial & above).any(-1).reshape(st.batch, -1).sum(1)
    return torch.full_like(undecided, res * res), undecided


@pytest.mark.parametrize('task', ['MoveToCorner', 'ClusterColour'])
@pytest.mark.parametrize('view', ['allo', 'ego'])
def test_hi_render_kernel_counts_its_undecided_pixels(host_lib, task, view):
    """K4's step entry, built for the host, with its pixel counts on
    TestAll states (30 and 138 prims): every pixel of each env's frame,
    and those left undecided by their classes, as a plain float64 count
    from the display list gives them (held between the counts with the
    reach and the boxes shrunk and grown by rounding's width, equal where
    those agree); a few percent of the pixels, none of them where the
    frame differs from the plain hi render."""
    st, scene, ss = _family_scene(task, 'TestAll', 7, B=3)
    prog = render_kernel.program_arrays(*scene, ss)
    out = torch.empty((st.batch, 96, 96, 3), dtype=torch.uint8)
    pixels = torch.zeros((st.batch, len(render_kernel.K4_PIXELS)),
                         dtype=torch.int64)
    keep = _torch_trig(host_lib, st)
    fields, args = _scene_args(st, prog, out, 96, view, 4)
    assert host_lib.render_hi_into_slot(
        *args, *render_kernel.HI_TILE, None, None, pixels.data_ptr(),
        None) == 0
    assert host_lib.render_trig_misses() == 0
    del keep, fields
    plain = render.render_views(st, *scene, views=(view,), fidelity='hi',
                                static_shapes=ss)[view]
    assert torch.equal(out, plain)
    constants = (ctypes.c_float * 2)()
    host_lib.render_hi_class_constants(constants)
    reach = constants[0] / render_kernel.camera_args(view, 384)[1] \
        + constants[1]
    total, undecided = pixels.unbind(1)
    want_total, want = _plain_k4_pixels(st, scene, ss, view, reach)
    assert torch.equal(total, want_total)
    _, least = _plain_k4_pixels(st, scene, ss, view, reach, slack=-1e-6)
    _, most = _plain_k4_pixels(st, scene, ss, view, reach, slack=1e-6)
    assert bool(((least <= undecided) & (undecided <= most)).all())
    sure = least == most
    assert int(sure.sum()) >= st.batch - 1
    assert torch.equal(undecided[sure], want[sure])
    assert bool(((0.01 * total < undecided) & (undecided < 0.2 * total))
                .all()), undecided / total


# K4's classes (csrc/render_lo.cuh prim_class): the prim kinds of the
# sweep, as (kind, nv, radius, line width): a polygon fill, a rounded one
# (a block's square has radius 0.00213), a circle, the arena border's
# outline and a goal's stippled one.
PROBE_KINDS = {'polygon': (render.KIND_FILL, 4, 0.0, 0.0),
               'rounded': (render.KIND_FILL, 4, 0.01, 0.0),
               'circle': (render.KIND_FILL, 1, 0.05, 0.0),
               'outline': (render.KIND_LINE, 4, 0.0, 1.0),
               'stipple': (render.KIND_LINE_STIPPLE, 4, 0.0, 2.5)}
PROBE_F = 2 * render.NV + 8
N_ANGLES_HI = 64


def _probe_camera(view, res=384):
    """The probe's camera floats of the 4x grid at `res` for `view` (the
    ego view's robot at a fixed pose), and each pixel's centre in float64:
    (cam_f float32, ego, centre(row, col) -> (x, y))."""
    ego, scale, half, npx, npy, lw_scale, two_scale, *bg = (
        np.float32(x) for x in render_kernel.camera_args(view, res))
    c, s, rx, ry = (np.float32(x) for x in (np.cos(0.7), np.sin(0.7), 0.2,
                                            -0.3))
    if not ego:
        c, s, rx, ry = (np.float32(x) for x in (1.0, 0.0, 0.0, 0.0))
    cam_f = np.array([scale, half, npx, npy, c, s, rx, ry, lw_scale,
                      two_scale, *bg], np.float32)
    f = [float(x) for x in cam_f]

    def centre(row, col):
        cx = (4 * col + 2) / f[0]
        if not ego:
            return cx - f[1], f[1] - (4 * row + 2) / f[0]
        spx, spy = cx - f[2], (res - (4 * row + 2)) / f[0] - f[3]
        return f[4] * spx - f[5] * spy + f[6], f[5] * spx + f[4] * spy + f[7]
    return cam_f, int(ego), centre


def _probe_prims(kind, centre, theta, dist, tangent, colour):
    """Prims of PROBE_KINDS[kind], one for each entry of the arrays
    `centre` (n, 2), `theta`, `dist` and `tangent` (n,): each one's SDF at
    world point `centre` is `dist`, nearest to it across a face (a circle:
    its rim) whose outward normal points at angle `theta`, a polygon moved
    `tangent` along that face; (n, PROBE_F) floats."""
    k, nv, rad, lw = PROBE_KINDS[kind]
    n = np.stack([np.cos(theta), np.sin(theta)], -1)
    t = np.stack([-n[:, 1], n[:, 0]], -1)
    out = np.zeros((len(theta), PROBE_F))
    if nv == 1:
        c = centre - (rad + dist)[:, None] * n
        out[:, :2 * render.NV] = np.tile(c, render.NV)
    else:
        h = 0.3           # the box TR, TL, BL, BR: face 0's normal is +y
        local = np.array([[h, h], [-h, h], [-h, -h], [h, -h]])
        rot = theta - np.pi / 2
        m = np.stack([np.stack([np.cos(rot), -np.sin(rot)], -1),
                      np.stack([np.sin(rot), np.cos(rot)], -1)], -2)
        c = centre - (h + rad + dist)[:, None] * n + tangent[:, None] * t
        v = np.einsum('vj,nij->nvi', local, m) + c[:, None]
        out[:, :2 * render.NV] = np.concatenate(
            [v, np.repeat(v[:, 3:], 4, 1)], 1).reshape(len(theta), -1)
    out[:, 2 * render.NV:] = [nv, rad, *colour, k, lw, 1.0]
    return out


def _probe(host_lib, prims, pixels, cam_f, ego, reach=0.0, res=384):
    """render_hi_probe over cases of prims (n_cases, n_prims, PROBE_F) and
    one output pixel each (n_cases, 2): (classes, alphas, classed bytes,
    plain bytes, undecided)."""
    prims = np.ascontiguousarray(prims, np.float32)
    pixels = np.ascontiguousarray(pixels, np.int32)
    n_cases, n_prims = prims.shape[:2]
    classes = np.empty((n_cases, n_prims), np.int32)
    alphas = np.empty((n_cases, n_prims, 16), np.float32)
    classed, plain = (np.empty((n_cases, 3), np.uint8) for _ in range(2))
    undecided = np.empty(n_cases, np.int32)
    def ptr(x):
        return x.ctypes.data_as(ctypes.c_void_p)
    assert host_lib.render_hi_probe(
        ptr(prims), n_cases, n_prims, ptr(cam_f), ego, res, ptr(pixels),
        reach, ptr(classes), ptr(alphas), ptr(classed), ptr(plain),
        ptr(undecided)) == 0
    return classes, alphas, classed, plain, undecided


# the arena's fill under every probe: a square far larger than the view
GROUND = np.array([10.0, 10.0, -10.0, 10.0, -10.0, -10.0] + [10.0, -10.0] * 5
                  + [4, 0.0, 1.0, 1.0, 1.0, render.KIND_FILL, 0.0, 1.0])


def _class_sweep(host_lib, reach=0.0):
    """Every prim kind of PROBE_KINDS over a full fill (the arena's), at
    N_ANGLES_HI directions, several pixels of both views and tangent
    offsets, at distances from the pixel's centre across the pixel
    (quarter-subpixel steps) and, in steps of 3e-8, around each threshold
    of the classes (a fill's +-R, an outline's band + R; R = HI_REACH
    subpixels, the margin left out), with the classes taken within `reach`
    (the kernel's where 0): per kind, the swept prim's (classes, alphas)
    and the pixels' (classed, plain, undecided)."""
    constants = (ctypes.c_float * 2)()
    host_lib.render_hi_class_constants(constants)
    hi_reach = float(constants[0])
    pixels = np.array([(40, 50), (13, 77), (88, 6)])
    out = {}
    for kind, (k, _, _, lw) in PROBE_KINDS.items():
        res = []
        for view in ('allo', 'ego'):
            cam_f, ego, centre = _probe_camera(view)
            scale = float(cam_f[0])
            r0 = hi_reach / scale
            edges = [r0, -r0] if k == render.KIND_FILL else [
                e * (max(lw, 1.0) / (2 * scale) + 0.5 / scale + r0)
                for e in (1, -1)]
            dists = np.concatenate(
                [np.linspace(-4, 4, 33) / scale]
                + [e + 3e-8 * np.arange(-48, 49) for e in edges])
            px, j, d = (x.reshape(-1) for x in np.meshgrid(
                np.arange(len(pixels)), np.arange(N_ANGLES_HI), dists,
                indexing='ij'))
            centres = np.array([centre(*p) for p in pixels])[px]
            prims = _probe_prims(kind, centres, 2 * np.pi * j / N_ANGLES_HI,
                                 d, 0.004 * ((7 * j + 3 * px) % 11),
                                 (0.2, 0.5, 0.7))
            prims = np.stack([np.broadcast_to(GROUND, prims.shape), prims], 1)
            res.append(_probe(host_lib, prims, pixels[px], cam_f, ego, reach))
        classes, alphas, classed, plain, undecided = (
            np.concatenate(x) for x in zip(*res))
        assert (classes[:, 0] == 1).all()           # the arena's fill: full
        out[kind] = (classes[:, 1], alphas[:, 1], classed, plain, undecided)
    return out


def _class_faults(swept):
    """Per kind, the sweep's cases in which a class is wrong (none with a
    subpixel covered, full with one not) or a pixel's bytes differ from
    shade_pixel_hi's."""
    faults = {}
    for kind, (classes, alphas, classed, plain, _) in swept.items():
        none = classes == 0
        full = classes == 1
        wrong = (none & (alphas != 0).any(1)) | (full & (alphas != 1).any(1))
        faults[kind] = int((wrong | (classed != plain).any(1)).sum())
    return faults


def test_hi_classes_hold_in_an_adversarial_sweep(host_lib):
    """K4's classes (prim_class within hi_class_reach) on every prim kind,
    at N_ANGLES_HI directions and sub-subpixel distances around each
    threshold: a prim classed none has coverage exactly 0 at all 16
    subpixels, one classed full exactly 1, only fills are ever full, and
    every pixel, decided whole or shaded from its start, has
    shade_pixel_hi's bytes; every kind is classed none and partial, every
    fill full, and pixels are both decided and undecided."""
    swept = _class_sweep(host_lib)
    assert _class_faults(swept) == dict.fromkeys(PROBE_KINDS, 0)
    for kind, (classes, _, _, _, undecided) in swept.items():
        fill = PROBE_KINDS[kind][0] == render.KIND_FILL
        assert set(np.unique(classes)) == ({0, 1, 2} if fill else {0, 2}), \
            kind
        assert 0 < undecided.mean() < 1, kind


@pytest.mark.parametrize('mutant', ['margin 0', 'radius sqrt 2'])
def test_hi_classes_without_their_reach_fail_the_sweep(host_lib, mutant):
    """The sweep catches a reach short of the classes': without the
    rounding margin (HI_REACH subpixels alone), or with the distance to
    the nearest diagonal subpixel (sqrt 2) in place of the farthest's, some
    prim is classed none or full where a subpixel says otherwise."""
    constants = (ctypes.c_float * 2)()
    host_lib.render_hi_class_constants(constants)
    scale = np.float32(render_kernel.camera_args('allo', 384)[1])
    sub = np.float32(constants[0]) if mutant == 'margin 0' \
        else np.float32(np.sqrt(2.0))
    faults = _class_faults(_class_sweep(host_lib, float(sub / scale)))
    assert sum(faults.values()) > 0, faults


@pytest.mark.parametrize('task', ['FixColour', 'MakeLine', 'FindDupe',
                                  'MatchRegions', 'ClusterColour'])
def test_physics_kernel_arithmetic_at_every_block_count(host_lib, task):
    """control_step_warp<MB> at the families' block counts (3, 4, 7, 8, 10),
    from TestAll resets (every block shape) after a few random steps:
    one substep to rounding, one control step to the median env."""
    t = ALL_TASKS[task]
    mb = t.max_blocks
    assert mb in physics_kernel.SUPPORTED_MAX_BLOCKS
    ftab, itab, _ = physics_kernel.table_arrays(mb)
    ftab, itab = torch.from_numpy(ftab), torch.from_numpy(itab)
    B = 8
    st = t.reset_fn(torch.Generator().manual_seed(1), B,
                    t.flags_for('TestAll'), 'cpu')
    rng = np.random.default_rng(mb)
    acts = torch.from_numpy(rng.integers(0, 18, (3, B)).astype(np.int32))
    for a in acts[:2]:
        st = physics.control_step(st, a)
    a = acts[2]
    sk = _kernel_step(host_lib, st, a, ftab, itab, 1)
    sp = physics.control_step(st, a, phys_steps=1)
    assert torch.equal(sk.pos, sp.pos) and torch.equal(sk.angle, sp.angle)
    for f in FIELDS:
        assert float((getattr(sk, f) - getattr(sp, f)).abs().max()) \
            <= SUBSTEP_ATOL, f
    assert torch.equal(sk.con_id, sp.con_id)
    sk = _kernel_step(host_lib, st, a, ftab, itab, C.PHYS_STEPS)
    sp = physics.control_step(st, a)
    for f in ('pos', 'angle') + FIELDS:
        err = (getattr(sk, f) - getattr(sp, f)).abs() \
            .reshape(st.batch, -1).amax(1)
        assert float(err.median()) <= STEP_MEDIAN_ATOL, f
    assert torch.equal(sk.t, sp.t)
    # a block count the kernel is not built for
    assert host_lib.physics_control_step(
        *physics_kernel.kernel_args(sk, a, ftab, itab)[:-6], B, 2, 1, 1,
        None, None, None) != 0


@pytest.mark.parametrize('task', ['FixColour', 'ClusterShape'])
@pytest.mark.parametrize('view', ['allo', 'ego'])
def test_tiles2d_kernel_arithmetic_matches_plain(host_lib, task, view):
    """K5's build from the state, cull and compaction, built for the host:
    its frames equal the plain lo render at 96² and 384², for tiles of
    several shapes, and the screen boxes of the prims it builds equal the
    plain ones of the plain display list."""
    st, scene, _ = _family_scene(task, 'TestAll', 2)
    disp = render_kernel.kernel_display(st, *scene)
    prog = render_kernel.program_arrays(*scene)
    P = disp['nv'].shape[1]
    assert prog[0].shape[0] == P
    for res, tiles in ((96, ((16, 16), (32, 32), (8, 48))),
                       (384, ((32, 32),))):
        plain = render.render_views(st, *scene, res=res, views=(view,),
                                    fidelity='lo')[view]
        for tile in tiles:
            out = _scene_frame(host_lib, st, scene, None, view, res=res,
                               tile=tile, entry='render_lo_tiles2d')
            assert torch.equal(out, plain), (res, tile)
        bb = torch.empty((st.batch, P, 4))
        bounded = torch.empty((st.batch, P), dtype=torch.int32)
        keep = _torch_trig(host_lib, st)
        fields, args = _scene_args(st, prog, plain, res, view)
        assert host_lib.render_prim_bboxes(
            *args, *tiles[0], bb.data_ptr(), bounded.data_ptr()) == 0
        assert host_lib.render_trig_misses() == 0
        del keep, fields
        pbb, pbounded = render_kernel.prim_screen_bboxes(disp, st, view, res)
        assert torch.equal(bounded.bool(), pbounded)
        assert bool((pbounded | ~disp['active']).all())
        # the same formulas; the plain version's gathers add in another
        # order: within 1e-3 px
        torch.testing.assert_close(bb[pbounded], pbb[pbounded], rtol=0,
                                   atol=1e-3)
    out = torch.empty((st.batch, 96, 96, 3), dtype=torch.uint8)
    fields, args = _scene_args(st, prog, out, 96, view)
    assert host_lib.render_lo_tiles2d(*args, 7, 16, None) != 0


# After 5 control steps the solver's chaos has grown the last-ulp
# differences in some envs: chip_smoke.py's floors (PHYS_FLOOR), against
# which the median env is held unless the plain version's own divergence
# from 1-ulp-nudged positions is larger (then twice that).
FIVE_STEP_FLOOR = {'pos': 1e-4, 'angle': 1e-4, 'vel': 1e-3, 'omega': 1e-3,
                   'con_jn': 1e-3, 'con_jt': 1e-3, 'joint_acc': 1e-3}


@pytest.mark.parametrize('task', ['MoveToCorner', 'MakeLine',
                                  'ClusterColour'])
def test_warp_control_step_matches_plain_over_steps(host_lib, task):
    """The one-warp-per-env control step (control_step_warp, each phase
    run lane by lane) at mb = 1, 4 and 10, from TestAll resets after two
    random steps, against the plain version: after 1 control step the
    median env within STEP_MEDIAN_ATOL in every field, after 5 within
    FIVE_STEP_FLOOR or twice the plain version's own 1-ulp divergence;
    the step counters equal; and two runs give the same bits."""
    t = ALL_TASKS[task]
    ftab, itab, _ = physics_kernel.table_arrays(t.max_blocks)
    ftab, itab = torch.from_numpy(ftab), torch.from_numpy(itab)
    B = 8
    st = t.reset_fn(torch.Generator().manual_seed(4), B,
                    t.flags_for('TestAll'), 'cpu')
    rng = np.random.default_rng(t.max_blocks)
    acts = torch.from_numpy(rng.integers(0, 18, (7, B)).astype(np.int32))
    for a in acts[:2]:
        st = physics.control_step(st, a)
    sk, sp = st.clone(), st
    sc = st.replace(pos=torch.nextafter(st.pos, torch.full_like(
        st.pos, float('inf'))))
    for n, a in enumerate(acts[2:], 1):
        again = _kernel_step(host_lib, sk, a, ftab, itab, C.PHYS_STEPS)
        sk = _kernel_step(host_lib, sk, a, ftab, itab, C.PHYS_STEPS)
        sp = physics.control_step(sp, a)
        sc = physics.control_step(sc, a)
        assert all(torch.equal(getattr(again, f), getattr(sk, f))
                   for f in ('pos', 'angle', 'con_id') + FIELDS)
        if n == 1:
            for f in ('pos', 'angle') + FIELDS:
                err = (getattr(sk, f) - getattr(sp, f)).abs() \
                    .reshape(B, -1).amax(1)
                assert float(err.median()) <= STEP_MEDIAN_ATOL, (n, f)
        if n == 5:
            for f, floor in FIVE_STEP_FLOOR.items():
                err, chaos = ((getattr(x, f) - getattr(sp, f)).abs()
                              .reshape(B, -1).amax(1) for x in (sk, sc))
                assert float(err.median()) <= max(
                    floor, 2 * float(chaos.median())), (n, f)
        assert torch.equal(sk.t, sp.t)


# The orders in which the host build runs each phase's lanes.
LANE_ORDERS = {'forward': np.arange(32), 'reverse': np.arange(32)[::-1],
               'permuted': np.random.RandomState(0).permutation(32)}


def _set_lane_order(host_lib, order):
    order = np.ascontiguousarray(order, np.int32)
    return host_lib.physics_set_lane_order(order.ctypes.data)


@pytest.mark.parametrize('task', ['MoveToCorner', 'MakeLine',
                                  'ClusterColour'])
def test_warp_control_step_is_the_same_in_every_lane_order(host_lib, task):
    """On the card the lanes of a phase of control_step_warp run at once,
    so no lane may read what another lane of the phase writes (WARP_PHASE,
    csrc/physics_step.cuh); a phase that did would race there.  The host
    build runs the lanes one by one, in an order the test chooses: at mb =
    1, 4 and 10, from TestAll resets with every body moved and turned at
    random (so that bodies touch), three control steps give the same bits
    in every field with the lanes in order, in reverse and in a seeded
    permutation."""
    t = ALL_TASKS[task]
    ftab, itab, _ = physics_kernel.table_arrays(t.max_blocks)
    ftab, itab = torch.from_numpy(ftab), torch.from_numpy(itab)
    B = 8
    st, _, _ = _family_scene(task, 'TestAll', 4, B=B)
    rng = np.random.default_rng(t.max_blocks)
    acts = torch.from_numpy(rng.integers(0, 18, (3, B)).astype(np.int32))
    runs = {}
    try:
        for name, order in LANE_ORDERS.items():
            assert _set_lane_order(host_lib, order) == 0
            sk, n_contact = st.clone(), 0
            for a in acts:
                sk = _kernel_step(host_lib, sk, a, ftab, itab, C.PHYS_STEPS)
                n_contact += int((sk.con_id >= 0).sum())
            runs[name] = sk
            assert n_contact > 0
        # not a permutation: refused
        assert _set_lane_order(host_lib, np.zeros(32)) != 0
    finally:
        assert _set_lane_order(host_lib, LANE_ORDERS['forward']) == 0
    for name, sk in runs.items():
        for f in dataclasses.fields(sk):
            assert torch.equal(getattr(sk, f.name),
                               getattr(runs['forward'], f.name)), (name, f.name)


# ---------------------------------------------------------------------------
# The narrowphase's broadphase cull (csrc/physics_step.cuh near_item,
# narrowphase): an item is tested in full only where its slots' bounding
# circles come within CULL_MARGIN.
# ---------------------------------------------------------------------------

def _tables_for(mb):
    ftab, itab, _ = physics_kernel.table_arrays(mb)
    return torch.from_numpy(ftab), torch.from_numpy(itab)


def _item_tests(host_lib, st):
    """(near, valid), each (B, NITEM) int32: whether the cull keeps each
    item at the state's pose and whether its full test makes a valid
    contact; -1 for the items of inactive slots."""
    ftab, itab = _tables_for(st.max_blocks)
    ns, npair = physics.slot_tables(st.max_blocks)[0].size, \
        physics.pair_table(st.max_blocks)[0].size
    near, valid = (torch.empty((st.batch, 4 * ns + npair), dtype=torch.int32)
                   for _ in range(2))
    sk = st.clone()
    a = torch.zeros(st.batch, dtype=torch.int32)
    assert host_lib.physics_item_tests(
        *physics_kernel.kernel_args(sk, a, ftab, itab), None,
        near.data_ptr(), valid.data_ptr()) == 0
    return near, valid


def _narrowphase(host_lib, st, dense):
    """One narrowphase of every env at its state's pose through the
    kernel's code (dense=False) or a full test of every item in candidate
    order (dense=True): nc (B,), ids (B, MAXC, 3), floats (B, MAXC, 8) and
    counts (B, 2) as physics_narrowphase writes them."""
    ftab, itab = _tables_for(st.max_blocks)
    maxc = st.con_id.shape[1]
    out = (torch.empty(st.batch, dtype=torch.int32),
           torch.empty((st.batch, maxc, 3), dtype=torch.int32),
           torch.empty((st.batch, maxc, 8)),
           torch.empty((st.batch, 2), dtype=torch.int64))
    sk = st.clone()
    a = torch.zeros(st.batch, dtype=torch.int32)
    assert host_lib.physics_narrowphase(
        *physics_kernel.kernel_args(sk, a, ftab, itab), None, int(dense),
        *(x.data_ptr() for x in out)) == 0
    return out


# The benchmark's three traffics: whole episodes of held random actions.
TRAFFIC = [('ClusterColour', 'TestAll'), ('ClusterColour', 'Demo'),
           ('MoveToCorner', 'Demo')]


def _held_states(host_lib, task, variant, B=6, n_steps=48, every=8,
                 seed=2 ** 31 + 16):
    """Every `every`-th state of a run of `n_steps` held random actions
    (the benchmark's, portbench/harness/traffic.py) from a `variant`
    reset, stepped by the host-built kernel."""
    from portbench.harness import traffic
    t = ALL_TASKS[task]
    ftab, itab = _tables_for(t.max_blocks)
    st = t.reset_fn(torch.Generator().manual_seed(seed), B,
                    t.flags_for(variant), 'cpu')
    acts = traffic.held_actions(seed, n_steps, B, 'cpu')
    out = []
    for i in range(n_steps):
        if i % every == 0:
            out.append(st)
        st = _kernel_step(host_lib, st, acts[i], ftab, itab, C.PHYS_STEPS)
    return out


@pytest.mark.parametrize('task,variant', TRAFFIC)
def test_no_culled_item_makes_a_contact_along_episodes(host_lib, task,
                                                       variant):
    """Along held-random-action runs of the benchmark's three traffics, no
    item the cull drops makes a valid contact in its full test, while
    items do make contacts; on ClusterColour the cull drops most items."""
    n_valid = n_culled = n_items = 0
    for st in _held_states(host_lib, task, variant):
        near, valid = _item_tests(host_lib, st)
        assert torch.equal(near < 0, valid < 0)
        assert not bool(((valid == 1) & (near == 0)).any())
        n_valid += int((valid == 1).sum())
        n_culled += int((near == 0).sum())
        n_items += int((near >= 0).sum())
    assert n_valid > 0
    if task == 'ClusterColour':
        assert n_culled > 0.9 * n_items


def _slot_kinds():
    """Every collision slot kind, (name, body kind, sub-shape, local
    bounding circle): the robot's body circle and four finger boxes
    ('robot', slot), then each block shape's active sub-shapes ('block',
    (shape, k))."""
    block_b = physics_kernel.slot_bounds(G.BLOCK_VERTS, G.BLOCK_SUB_NV,
                                         G.BLOCK_SUB_RADIUS)
    robot_b = physics_kernel.slot_bounds(*physics.robot_slot_geometry())
    kinds = [('robot', s, tuple(robot_b[s])) for s in range(5)]
    for t in range(G.N_SHAPE_TYPES):
        for k in range(physics.KSUB):
            if G.BLOCK_SUB_ACTIVE[t, k]:
                kinds.append(('block', (t, k), tuple(block_b[t, k])))
    return kinds


# Circle gaps the sweep puts between two slots (or a slot and its wall):
# overlapping, touching, the square's worst SAT case (< 0.0018), and just
# inside and outside the cull's threshold (filled in with the margin).
SWEEP_GAPS = (-0.01, -0.002, -0.0005, 0.0, 0.0005, 0.001, 0.0015, 0.002)
N_ANGLES = 64


def _rot(theta, v):
    v = np.asarray(v, np.float64)
    c, s = np.cos(theta), np.sin(theta)
    return np.stack([c * v[..., 0] - s * v[..., 1],
                     s * v[..., 0] + c * v[..., 1]], -1)


def _sweep_state(kinds, poses):
    """A FixColour-sized state (3 blocks) an env a row of `poses`: each
    row sets the pose (x, y, angle) of the bodies of up to two slot
    kinds, the first on block 0 or its robot body, the second on block 1
    or its robot body; the robot stands away from them."""
    from magical_tpu_torch.core import state as S
    n = len(poses)
    st = S.make_initial_state(n, 3, 3, 'cpu')
    st = S.place_robot(st, torch.full((n, 2), -0.6), torch.zeros(n))
    slot_body, _ = physics.slot_tables(3)
    pos, ang = st.pos.clone(), st.angle.clone()
    shape = st.block_shape.clone()
    active = st.block_active.clone()
    for row, parts in enumerate(poses):
        for j, (kind, xy_theta) in enumerate(zip(kinds, parts)):
            if kind[0] == 'robot':
                body = int(slot_body[kind[1]])
            else:
                body = 5 + j
                shape[row, j] = kind[1][0]
                active[row, j] = True
            pos[row, body] = torch.tensor(xy_theta[:2], dtype=torch.float32)
            ang[row, body] = float(xy_theta[2])
    return st.replace(pos=pos, angle=ang, block_shape=shape,
                      block_active=active)


def _slot_of(kind, j):
    return kind[1] if kind[0] == 'robot' else 5 + j * physics.KSUB + \
        kind[1][1]


def test_no_culled_item_makes_a_contact_in_a_sweep(host_lib):
    """Every pair of slot kinds the pair table holds (robot slots against
    block sub-shapes, block sub-shapes of two blocks) and every slot kind
    against each wall, at N_ANGLES directions and body angles, at circle
    gaps from overlap through the square's worst SAT case to just inside
    and just outside the cull's threshold: no item the cull drops makes a
    valid contact; the swept items make contacts when the circles overlap
    and, squares corner to corner, at gaps up to 0.0018; they are kept just
    inside the threshold and dropped just outside it."""
    margin = float(host_lib.physics_cull_margin())
    assert 0.002 < margin < 0.1
    gaps = SWEEP_GAPS + (margin - 1e-4, margin + 1e-4)
    kinds = _slot_kinds()
    # the direction from A to B, and each body's angle from it: every
    # relative orientation a multiple of 2 pi / N_ANGLES, among them
    # squares corner to corner (j = 0, 16, 32, 48), SAT's worst case
    j = np.arange(N_ANGLES)
    phi = 2 * np.pi * j / N_ANGLES + 0.05
    theta_a = phi - np.pi / 4 + 2 * np.pi * (7 * j % N_ANGLES) / N_ANGLES
    theta_b = phi + 3 * np.pi / 4 \
        + 2 * np.pi * (13 * j % N_ANGLES) / N_ANGLES
    pa, pb = physics.pair_table(3)
    ns = 5 + 3 * physics.KSUB
    pair_item = {(int(a), int(b)): 4 * ns + i
                 for i, (a, b) in enumerate(zip(pa, pb))}
    cases = []              # (kinds, poses, swept item, gap)
    for x, ka in enumerate(kinds):
        for kb in kinds[x:]:
            if kb[0] == 'robot':
                continue
            pair = (ka, kb)
            item = pair_item[(_slot_of(ka, 0), _slot_of(kb, 1))]
            ca = np.array([0.25, 0.2])
            for g in gaps:
                cb = ca + (ka[2][2] + kb[2][2] + g) * np.stack(
                    [np.cos(phi), np.sin(phi)], -1)
                pos_a = ca - _rot(theta_a, ka[2][:2])
                pos_b = cb - _rot(theta_b, kb[2][:2])
                for q in range(N_ANGLES):
                    cases.append((pair, ((*pos_a[q], theta_a[q]),
                                         (*pos_b[q], theta_b[q])), item, g))
        normals = np.array([[1., 0.], [-1., 0.], [0., 1.], [0., -1.]])
        for wi, n in enumerate(normals):
            item = wi * ns + _slot_of(ka, 0)
            for g in gaps:
                c = (ka[2][2] + g - 1.0) * n + 0.3 * np.sin(phi)[:, None] \
                    * n[::-1]
                pos = c - _rot(theta_a, ka[2][:2])
                for q in range(N_ANGLES):
                    cases.append(((ka,), ((*pos[q], theta_a[q]),), item, g))
    by_kinds = {}
    for case in cases:
        by_kinds.setdefault(case[0], []).append(case)
    swept = {g: [] for g in gaps}       # (near, valid) of each swept item
    n_culled = 0
    for pair, group in by_kinds.items():
        st = _sweep_state(pair, [c[1] for c in group])
        near, valid = _item_tests(host_lib, st)
        assert not bool(((valid == 1) & (near == 0)).any()), pair
        n_culled += int((near == 0).sum())
        for row, (_, _, item, g) in enumerate(group):
            swept[g].append((int(near[row, item]), int(valid[row, item])))
    swept = {g: np.array(v) for g, v in swept.items()}
    assert all((v >= 0).all() for v in swept.values())
    assert swept[-0.01][:, 1].mean() > 0.2        # overlapping: contacts
    # squares corner to corner: SAT's separation finds an overlap at a
    # positive gap, which the margin covers (CULL_MARGIN)
    assert swept[0.001][:, 1].any() and not swept[0.002][:, 1].any()
    assert (swept[margin - 1e-4][:, 0] == 1).all()
    assert (swept[margin + 1e-4][:, 0] == 0).all()
    assert n_culled > 0


@pytest.mark.parametrize('task,variant', TRAFFIC + [
    ('FixColour', 'TestAll'), ('MatchRegions', 'TestAll')])
def test_culled_narrowphase_lists_the_dense_contacts(host_lib, task,
                                                     variant):
    """After one narrowphase of the host-built warp step (the cull, then
    the full tests of the near items), the compacted contact list (count,
    candidate ids, bodies, normals, lever arms, biases, frictions) equals,
    bit for bit, the list of a full test of every item in candidate order;
    the counts hold tested <= items, tested >= the items with a valid
    contact, and tested == items where the list fits one round."""
    n_long = n_contacts = 0
    for st in _held_states(host_lib, task, variant):
        got = _narrowphase(host_lib, st, dense=False)
        want = _narrowphase(host_lib, st, dense=True)
        for x, y in zip(got[:3], want[:3]):
            assert torch.equal(x, y)
        items, tested = got[3].unbind(1)
        _, valid = _item_tests(host_lib, st)
        assert torch.equal(items, (valid >= 0).sum(1).long())
        assert torch.equal(want[3][:, 1], items)
        assert bool((tested <= items).all())
        assert bool((tested >= (valid == 1).sum(1)).all())
        short = items <= 32
        assert torch.equal(tested[short], items[short])
        n_long += int((~short).sum())
        n_contacts += int(got[0].sum())
    assert n_contacts > 0
    if task != 'MoveToCorner':
        assert n_long > 0


@pytest.mark.parametrize('task,variant', TRAFFIC)
def test_control_step_counts_its_items(host_lib, task, variant):
    """The host-built control step with item_count: each env's items are
    its list's length in every substep, the items tested in full at most
    those and, on ClusterColour, a few percent of them; the state's bits
    are those of a step without the count."""
    st = _held_states(host_lib, task, variant, n_steps=9)[-1]
    ftab, itab = _tables_for(st.max_blocks)
    a = torch.arange(st.batch, dtype=torch.int32) % C.N_ACTIONS
    count = torch.zeros((st.batch, len(physics_kernel.ITEMS)),
                        dtype=torch.int64)
    sk = st.clone()
    assert host_lib.physics_control_step(
        *physics_kernel.kernel_args(sk, a, ftab, itab, item_count=count),
        None) == 0
    plain = _kernel_step(host_lib, st, a, ftab, itab, C.PHYS_STEPS)
    for f in dataclasses.fields(sk):
        assert torch.equal(getattr(sk, f.name), getattr(plain, f.name))
    items = _narrowphase(host_lib, st, dense=True)[3][:, 0]
    candidates, tested = count.unbind(1)
    assert torch.equal(candidates, C.PHYS_STEPS * items)
    assert bool((tested <= candidates).all())
    if task == 'ClusterColour':
        assert 0 < int(tested.sum()) < 0.1 * int(candidates.sum())
    else:
        assert torch.equal(tested, candidates)
