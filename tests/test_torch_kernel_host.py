"""The CUDA kernels' own arithmetic, built for the host, against their plain
PyTorch versions.

A CUDA kernel cannot run without the card, but the per-env physics and
per-pixel compositing of ``magical_tpu_torch/csrc`` live in
``__host__ __device__`` functions (``*.cuh``).  ``kernel_host_shim.cpp``
loops them over the batch; it is built here with the host C++ compiler,
with FMA contraction off, and called with the same tables and arguments
the CUDA wrappers pass.  The kernels on the card are held against the same
plain versions by ``chip_smoke.py``.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from magical_tpu_torch import _build
from magical_tpu_torch import constants as C
from magical_tpu_torch.core import physics, physics_kernel, render
from magical_tpu_torch.core import render_kernel
from magical_tpu_torch.tasks import ALL_TASKS

from _torch_port import seek_block_actions

HERE = os.path.dirname(os.path.abspath(__file__))
TASK = ALL_TASKS['MoveToCorner']
SS = TASK.static_block_shapes(TASK.flags_for('Demo'))


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    cxx = shutil.which('c++') or shutil.which('g++')
    if cxx is None:
        pytest.skip('no host C++ compiler to build the kernel sources')
    out = tmp_path_factory.mktemp('kernel_host') / 'libkernel_host.so'
    subprocess.run(
        [cxx, '-O2', '-std=c++17', '-ffp-contract=off', '-shared', '-fPIC',
         '-I', str(_build.CSRC_DIR), '-o', str(out),
         os.path.join(HERE, 'kernel_host_shim.cpp')],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    # the host build's physics_control_step takes every block count, with
    # the arguments of the kernel's per-block-count entry points
    sigs = dict(_build.SIGNATURES, physics_control_step=_build.SIGNATURES[
        'physics_control_step_mb1'])
    P = ctypes.c_void_p
    sigs['render_build_display'] = sigs['render_lo_frame'][:-1] + [P] * 5
    sigs['render_prim_bboxes'] = sigs['render_lo_frame'][:-1] + [P] * 2
    sigs['render_set_trig'] = [P] * 3 + [ctypes.c_int]
    sigs['physics_set_lane_order'] = [P]
    for name in ('physics_table_layout', 'physics_control_step',
                 'physics_set_lane_order',
                 'render_program_layout', 'render_lo_frame',
                 'render_build_display', 'render_hi_frame',
                 'render_lo_tiles2d', 'render_prim_bboxes',
                 'render_set_trig'):
        fn = getattr(lib, name)
        fn.argtypes = sigs[name]
        fn.restype = ctypes.c_int
    lib.render_trig_misses.restype = ctypes.c_long
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


def _torch_trig(host_lib, st):
    """Hand the host build PyTorch's CPU cos and sin of every angle that
    build_prim and the camera take: each body's, and each pupil's relative
    to the robot's."""
    x = torch.cat([st.angle.reshape(-1), st.angle[:, 3] - st.angle[:, 0],
                   st.angle[:, 4] - st.angle[:, 0]]).contiguous()
    c, s = torch.cos(x), torch.sin(x)
    assert host_lib.render_set_trig(x.data_ptr(), c.data_ptr(),
                                    s.data_ptr(), x.numel()) == 0
    return (x, c, s)                 # kept alive while the host reads them


def _scene_args(st, prog, out, res, view, grid=1):
    """The arguments of the render entry points but the tile and the
    stream, the camera on the grid `grid` times finer than `res`."""
    fields = [getattr(st, name).contiguous()
              for name, _ in render_kernel._SCENE_FIELDS]
    ptrs = [x.data_ptr() for x in fields + [torch.from_numpy(a)
                                            for a in prog] + [out]]
    return fields, ptrs + [st.batch, prog[0].shape[0], res, st.n_bodies,
                           st.max_blocks, st.goal_xyhw.shape[1],
                           *render_kernel.camera_args(view, grid * res)]


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
        *physics_kernel.kernel_args(sk, a, ftab, itab)[:-5], B, 2, 1, 1,
        None, None) != 0


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
