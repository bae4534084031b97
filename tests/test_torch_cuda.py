"""The port's CUDA kernels on the card, against their plain PyTorch
versions: ragged batch sizes, the wrappers' input checks, the ring-slot
write, the hi render at 96² and 384², the control step at every block
count, the renders (2-D tiled too, and the hi render over several tilings)
at 138 display prims, the slices on CUDA against the same slices on the
CPU, the lo renders building the display list of every family on the
card, renders that build no display list on the host, a lo step that
copies nothing from the host, the control step giving the same bits
twice, the port's spans against the benchmark's layer ranges and K1's
cycles a phase, K4's counters against the host build's, the reset's
placement kernel against its plain version on the card; the
data-parallel path on an NCCL group of one rank (the gathered rollout
scores, a BC step over the mesh) and the CLI on the card.

Marked `cuda`; every test skips without a CUDA card.  On a machine with
one:  python -m pytest -m cuda tests/test_torch_cuda.py -q
(chip_smoke.py holds the same kernels at the main path's shapes).
"""

import dataclasses

import numpy as np
import pytest
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch import trace
from magical_tpu_torch.api.batched_env import BatchedEnv
from magical_tpu_torch.core import (physics, physics_kernel, preproc, render,
                                    render_kernel)
from magical_tpu_torch.core.state import make_initial_state
from magical_tpu_torch.tasks import ALL_TASKS, base, place_kernel, randomize

import _kernel_host

pytestmark = pytest.mark.cuda

NAME = 'MoveToCorner-Demo-LoRes4E-v0'
# Built without FMA contraction, the kernels round like their plain
# versions; the control step still differs where the plain version's
# per-body impulse sums (scatter_add_ with atomics on CUDA) add in another
# order, which the solver grows in its chaotic envs: the median env agrees
# to 1e-6.  Frames: within 1 uint8 level.
STEP_MEDIAN_ATOL = 1e-6
MAX_LEVELS = 1
# Hi frames: hard fill edges, one subpixel rounding to the other side
# moves a value by up to 16 levels; the kernel rounds as the plain version
# does and is held to at most that on at most 1e-5 of the values.
HI_MAX_LEVELS = 16
HI_MAX_SHARE = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels run only there')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _states(batch, n_steps, cuda):
    env = BatchedEnv(NAME, device=cuda)
    carry, _ = env.reset(0, batch)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for _ in range(n_steps):
        act = torch.randint(0, 18, (batch,), generator=gen, device=cuda,
                            dtype=torch.int32)
        carry, *_ = env.step(carry, act)
    act = torch.randint(0, 18, (batch,), generator=gen, device=cuda,
                        dtype=torch.int32)
    return env, carry.state.clone(), act


@pytest.mark.parametrize('batch', [1, 129, 300])
def test_control_step_kernel_any_batch(cuda, batch):
    _, st, act = _states(batch, 6, cuda)
    sp = physics.control_step(st, act)
    sk = st.clone()
    n = physics_kernel.control_step.launches
    out = physics_kernel.control_step(sk, act)
    torch.cuda.synchronize()
    assert out is sk and physics_kernel.control_step.launches == n + 1
    for f in ('pos', 'angle', 'vel', 'omega', 'con_jn', 'con_jt',
              'joint_acc'):
        err = (getattr(sk, f) - getattr(sp, f)).abs().reshape(batch, -1) \
            .amax(1)
        assert float(err.median()) <= STEP_MEDIAN_ATOL, f
    assert torch.equal(sk.con_id, sp.con_id)
    assert torch.equal(sk.t, sp.t)


def test_control_step_kernel_rejects_what_it_does_not_take(cuda):
    _, st, act = _states(4, 0, cuda)
    with pytest.raises(TypeError):
        physics_kernel.control_step(st, act.long())
    with pytest.raises(ValueError):
        physics_kernel.control_step(st, act.cpu())
    with pytest.raises(ValueError):
        physics_kernel.control_step(st, torch.stack([act, act], 1)[:, 0])
    # a block count no task family has
    with pytest.raises(ValueError, match='max_blocks'):
        physics_kernel.control_step(make_initial_state(4, 2, 1, cuda), act)


@pytest.mark.parametrize('batch', [1, 5, 300])
@pytest.mark.parametrize('view', ['allo', 'ego'])
def test_render_kernels_any_batch(cuda, batch, view):
    env, st, _ = _states(batch, 3, cuda)
    args = (env.task.max_blocks, env.task.max_goals, env.robot_first)
    plain = render.render_views(st, *args, views=(view,), fidelity='lo',
                                static_shapes=env.static_shapes)[view]
    fresh = render_kernel.render_views_lo(
        st, *args, views=(view,), static_shapes=env.static_shapes)[view]
    spec = preproc.PreprocSpec(None, **{f'{view}_frames': 4})
    ring = torch.full((4, batch, 96, 96, 3), 7, dtype=torch.uint8,
                      device=cuda)
    render_kernel.render_into_slots(st, {view: ring}, 6, *args, spec,
                                    static_shapes=env.static_shapes)
    torch.cuda.synchronize()
    assert bool((ring[[0, 1, 3]] == 7).all())          # slot 6 mod 4 only
    for got in (fresh, ring[2]):
        d = (got.int() - plain.int()).abs()
        assert int(d.max()) <= MAX_LEVELS


def test_slice_on_cuda_matches_the_slice_on_the_cpu(cuda):
    # actions that keep 8 steps free of contacts, where the two paths
    # agree to rounding (tests/test_torch_env.py)
    acts = torch.tensor([C.ACTION_NAMES.index(a) for a in (
        'UpOpen', 'RightOpen', 'LeftClose', 'DownClose')], dtype=torch.int32)
    envs = {d: BatchedEnv(NAME, device=d) for d in ('cpu', cuda)}
    out = {d: e.reset(0, 4) for d, e in envs.items()}
    for _ in range(8):
        out = {d: envs[d].step(out[d][0], acts.to(d)) for d in out}
    (cc, co, *_), (gc, go, *_) = out['cpu'], out[cuda]
    d = (go.cpu().int() - co.int()).abs()
    assert int(d.max()) <= MAX_LEVELS and float((d > 0).float().mean()) \
        <= 1e-3
    torch.testing.assert_close(gc.state.pos.cpu(), cc.state.pos, rtol=0,
                               atol=1e-4)
    assert gc.t == cc.t == 8


def _hi_close(got, plain):
    d = (got.int() - plain.int()).abs()
    assert int(d.max()) <= HI_MAX_LEVELS
    assert float((d > 0).double().mean()) <= HI_MAX_SHARE


@pytest.mark.parametrize('batch', [1, 5, 300])
@pytest.mark.parametrize('view', ['allo', 'ego'])
def test_hi_render_kernel_any_batch(cuda, batch, view):
    env = BatchedEnv('MoveToRegion-TestAll-LoRes4E-v0', device=cuda)
    carry, _ = env.reset(3, batch)
    st = carry.state
    args = (env.task.max_blocks, env.task.max_goals, env.robot_first)
    plain = render.render_views(st, *args, views=(view,), fidelity='hi',
                                static_shapes=env.static_shapes)[view]
    n = render_kernel.render_views_hi.launches
    fresh = render_kernel.render_views_hi(
        st, *args, views=(view,), static_shapes=env.static_shapes)[view]
    assert render_kernel.render_views_hi.launches == n + 1
    spec = preproc.PreprocSpec(None, **{f'{view}_frames': 4})
    ring = torch.full((4, batch, 96, 96, 3), 7, dtype=torch.uint8,
                      device=cuda)
    render_kernel.render_hi_into_slots(st, {view: ring}, 5, *args, spec,
                                       static_shapes=env.static_shapes)
    torch.cuda.synchronize()
    assert bool((ring[[0, 2, 3]] == 7).all())          # slot 5 mod 4 only
    for got in (fresh, ring[1]):
        _hi_close(got, plain)


def test_hi_render_kernel_raw_384_every_block_shape(cuda):
    env = BatchedEnv('MoveToCorner-TestShape-v0', fidelity='hi',
                     device=cuda)
    carry, obs = env.reset(0, 4)
    st = carry.state
    st.block_shape[:, 0] = torch.tensor(C.RAND_SHAPE_TYPES,
                                        dtype=torch.int32, device=cuda)
    got = render_kernel.render_views_hi(st, 1, 1, True, res=384)
    plain = render.render_views(st, 1, 1, True, res=384, fidelity='hi')
    for v in ('allo', 'ego'):
        assert got[v].shape == (4, 384, 384, 3)
        _hi_close(got[v], plain[v])


def test_hi_render_kernel_rejects_what_it_does_not_take(cuda):
    _, st, _ = _states(2, 0, cuda)
    out = render_kernel.render_views_hi(st, 1, 1, True)
    assert out['ego'].device.type == 'cuda'
    # ClusterColour's 10 blocks: 138 display prims, which the kernels take
    wide = make_initial_state(2, 10, 1, cuda)
    assert render_kernel.render_views_hi(wide, 10, 1, False)['ego'].shape \
        == (2, 96, 96, 3)
    # a display program past what the kernels keep, through the scene path
    # of K4 and K5
    prog = render_kernel.display_program(10, 1, False, None, cuda)
    n = render_kernel.MAX_PRIMS + 1 - prog[0].shape[0]
    long = (torch.cat([prog[0], prog[0][:n]]).contiguous(),
            torch.cat([prog[1], prog[1][:n]]).contiguous(), *prog[2:])
    frame = torch.empty((2, 96, 96, 3), dtype=torch.uint8, device=cuda)
    for entry in ('render_hi_frame', 'render_hi_into_slot',
                  'render_lo_tiles2d'):
        with pytest.raises(ValueError, match=str(render_kernel.MAX_PRIMS)):
            render_kernel._launch_scene(entry, long, wide, frame, 'ego', 96,
                                        (16, 16))


def test_hi_and_tiled_renders_build_no_display_list_on_the_host(
        cuda, monkeypatch):
    """K4 (fresh frames and ring slots, through a hi BatchedEnv's reset
    and step) and K5 take the state and the cached display program: on a
    CUDA state they call the plain build_display_list zero times."""
    calls = []
    build = render.build_display_list

    def counting(*args, **kwargs):
        calls.append(1)
        return build(*args, **kwargs)
    monkeypatch.setattr(render, 'build_display_list', counting)
    env = BatchedEnv('MoveToRegion-TestAll-LoRes4E-v0', fidelity='hi',
                     device=cuda)
    carry, _ = env.reset(0, 8)
    carry, *_ = env.step(carry, torch.zeros(8, dtype=torch.int32,
                                            device=cuda))
    args, ss = env._render_args(), env.static_shapes
    render_kernel.render_views_hi(carry.state, *args, res=384,
                                  static_shapes=ss)
    render_kernel.render_views_lo(carry.state, *args, static_shapes=ss,
                                  tiles2d=(16, 16))
    torch.cuda.synchronize()
    assert not calls
    # the counter counts: the plain render on the same state calls it
    render.render_views(carry.state, *args, fidelity='hi', static_shapes=ss)
    assert calls


def test_hi_slice_on_cuda_matches_the_slice_on_the_cpu(cuda):
    """MoveToCorner-TestAll at hi fidelity: the same seeded reset (drawn on
    the CPU generator either way) on both devices."""
    name = 'MoveToCorner-TestAll-LoRes4E-v0'
    out = {}
    for d in ('cpu', cuda):
        env = BatchedEnv(name, fidelity='hi', device=d)
        carry, obs = env.reset(5, 8)
        out[d] = (carry.state.pos.cpu(), obs.cpu().int(),
                  carry.state.place_fail.cpu())
    (cp, co, cf), (gp, go, gf) = out['cpu'], out[cuda]
    torch.testing.assert_close(gp, cp, rtol=0, atol=1e-5)
    assert torch.equal(gf, cf)
    d = (go - co).abs()
    assert int(d.max()) <= HI_MAX_LEVELS
    assert float((d > 0).float().mean()) <= 1e-3


# The six multi-block families: their block counts and their widest
# display lists (ClusterColour-TestAll: 138 prims).
FAMILY_IDS = ['FixColour', 'MakeLine', 'FindDupe', 'MatchRegions',
              'ClusterColour', 'ClusterShape']


def _family_states(cuda, family, batch, n_steps):
    env = BatchedEnv(f'{family}-TestAll-LoRes4E-v0', device=cuda)
    carry, _ = env.reset(2, batch)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for _ in range(n_steps):
        act = torch.randint(0, 18, (batch,), generator=gen, device=cuda,
                            dtype=torch.int32)
        carry, *_ = env.step(carry, act)
    act = torch.randint(0, 18, (batch,), generator=gen, device=cuda,
                        dtype=torch.int32)
    return env, carry.state.clone(), act


@pytest.mark.parametrize('family', FAMILY_IDS)
def test_control_step_kernel_at_every_block_count(cuda, family):
    """K1 at 3, 4, 7, 8 and 10 blocks: the median env within rounding of
    the plain version, and the contact ids equal in all but the chaotic
    few."""
    env, st, act = _family_states(cuda, family, 200, 2)
    assert st.max_blocks in physics_kernel.SUPPORTED_MAX_BLOCKS
    sp = physics.control_step(st, act)
    sk = physics_kernel.control_step(st.clone(), act)
    torch.cuda.synchronize()
    for f in ('pos', 'angle', 'vel', 'omega', 'con_jn', 'con_jt',
              'joint_acc'):
        err = (getattr(sk, f) - getattr(sp, f)).abs().reshape(200, -1) \
            .amax(1)
        assert float(err.median()) <= STEP_MEDIAN_ATOL, f
    assert float((sk.con_id != sp.con_id).any(1).float().mean()) <= 0.05
    assert torch.equal(sk.t, sp.t)


@pytest.mark.parametrize('view', ['allo', 'ego'])
def test_render_kernels_at_138_prims(cuda, view):
    """K2, K3, K4 and K5 on ClusterColour-TestAll states, 138 display
    prims: K2/K3 within a level of the plain lo render, K5 byte-equal to
    it and to K3, K4 within the hi tolerance."""
    env, st, _ = _family_states(cuda, 'ClusterColour', 24, 1)
    args = (env.task.max_blocks, env.task.max_goals, env.robot_first)
    ss = env.static_shapes
    prog = render_kernel.display_program(*args, ss, cuda)
    assert prog[0].shape[0] == 138
    plain = render.render_views(st, *args, views=(view,), fidelity='lo',
                                static_shapes=ss)[view]
    k3 = render_kernel.render_views_lo(st, *args, views=(view,),
                                       static_shapes=ss)[view]
    spec = preproc.PreprocSpec(None, **{f'{view}_frames': 4})
    ring = torch.zeros((4, 24, 96, 96, 3), dtype=torch.uint8, device=cuda)
    render_kernel.render_into_slots(st, {view: ring}, 3, *args, spec,
                                    static_shapes=ss)
    n = render_kernel.render_lo_tiles2d.launches
    for tiles in ((16, 16), (32, 32), (8, 48)):
        k5 = render_kernel.render_views_lo(st, *args, views=(view,),
                                           static_shapes=ss,
                                           tiles2d=tiles)[view]
        assert torch.equal(k5, plain) and torch.equal(k5, k3), tiles
    assert render_kernel.render_lo_tiles2d.launches == n + 3
    for got in (k3, ring[3]):
        assert int((got.int() - plain.int()).abs().max()) <= MAX_LEVELS
    hi = render_kernel.render_views_hi(st, *args, views=(view,),
                                       static_shapes=ss)[view]
    _hi_close(hi, render.render_views(st, *args, views=(view,),
                                      fidelity='hi', static_shapes=ss)[view])
    # K4's cull is exact: every tiling, ragged ones too, gives its bytes
    for tile in ((8, 8), (32, 32), (40, 28), (96, 96)):
        out = torch.empty_like(hi)
        render_kernel._launch_scene('render_hi_frame', prog, st, out, view,
                                    96, tile)
        assert torch.equal(out, hi), tile
    with pytest.raises(ValueError, match='divide'):
        render_kernel.render_views_lo(st, *args, tiles2d=(20, 16))


@pytest.mark.parametrize('family', ['MoveToCorner', 'MoveToRegion']
                         + FAMILY_IDS)
@pytest.mark.parametrize('variant', ['Demo', 'TestAll'])
def test_lo_render_kernels_build_every_display_list(cuda, family, variant):
    """K2 and K3 build each env's display list on the card from the state:
    within a level of the plain lo render on Demo and TestAll states of
    all eight families, allo and ego."""
    env = BatchedEnv(f'{family}-{variant}-LoRes4E-v0', device=cuda)
    carry, _ = env.reset(5, 16)
    carry, *_ = env.step(carry, torch.arange(16, device=cuda) % 18)
    st = carry.state
    args, ss = env._render_args(), env.static_shapes
    for view in ('allo', 'ego'):
        plain = render.render_views(st, *args, views=(view,), fidelity='lo',
                                    static_shapes=ss)[view]
        k3 = render_kernel.render_views_lo(st, *args, views=(view,),
                                           static_shapes=ss)[view]
        spec = preproc.PreprocSpec(None, **{f'{view}_frames': 4})
        ring = torch.zeros((4, 16, 96, 96, 3), dtype=torch.uint8,
                           device=cuda)
        render_kernel.render_into_slots(st, {view: ring}, 1, *args, spec,
                                        static_shapes=ss)
        for got in (k3, ring[1]):
            assert int((got.int() - plain.int()).abs().max()) <= MAX_LEVELS


def test_lo_step_copies_nothing_from_the_host(cuda):
    """A lo step of the main path (K1, K2, the observation, the score)
    makes no host-to-device copy: the render builds its display list on
    the card from a display program cached per scene."""
    from torch.profiler import ProfilerActivity, profile
    env = BatchedEnv(NAME, device=cuda)
    carry, _ = env.reset(0, 64)
    act = torch.zeros(64, dtype=torch.int32, device=cuda)
    for _ in range(2):
        carry, *_ = env.step(carry, act)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            carry, *_ = env.step(carry, act)
        torch.cuda.synchronize()
    h2d = sum(e.count for e in prof.key_averages() if 'HtoD' in e.key)
    assert h2d == 0


@pytest.mark.parametrize('family', FAMILY_IDS[:1] + FAMILY_IDS[-2:])
def test_control_step_kernel_gives_the_same_bits_twice(cuda, family):
    """One warp per env, per-body sums in a fixed order, no float atomics:
    two runs on the same inputs give the same bits, counting the cycles
    of each phase or not."""
    _, st, act = _family_states(cuda, family, 64, 2)
    counters = trace.KernelCounters()
    one = physics_kernel.control_step(st.clone(), act)
    two = physics_kernel.control_step(st.clone(), act, counters=counters)
    torch.cuda.synchronize()
    for f, _, _ in physics_kernel._fields(st.max_blocks):
        assert torch.equal(getattr(one, f), getattr(two, f)), f
    clock = counters.take('k1_cycles', 64, cuda)
    assert clock.shape == (64, len(physics_kernel.PHASES))
    assert bool((clock > 0).all())


def test_control_step_kernel_counts_the_items_it_culls(cuda):
    """K1's narrowphase culls by bounding circles: on ClusterColour-Demo
    states at mb 10, under a profiler, BatchedEnv.counters() reports 0 <
    tested < candidates, candidates being each env's items in each of the
    10 substeps; the count changes no bit of the step."""
    from torch.profiler import ProfilerActivity, profile

    env = BatchedEnv('ClusterColour-Demo-LoRes4E-v0', device=cuda)
    act = torch.arange(64, device=cuda, dtype=torch.int32) % C.N_ACTIONS
    carry, _ = env.reset(3, 64)
    env.step(carry, act)
    torch.cuda.synchronize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(2):
            carry, *_ = env.step(carry, act)
        torch.cuda.synchronize()
    items = env.counters()['k1_items']
    trace.clear()
    assert 0 < items['tested'] < items['candidates'], items
    counters = trace.KernelCounters()
    st = carry.state
    one = physics_kernel.control_step(st.clone(), act)
    two = physics_kernel.control_step(st.clone(), act, counters=counters)
    torch.cuda.synchronize()
    for f, _, _ in physics_kernel._fields(st.max_blocks):
        assert torch.equal(getattr(one, f), getattr(two, f)), f
    count = counters.take('k1_items', 64, cuda)
    assert count.shape == (64, len(physics_kernel.ITEMS))
    assert bool((count[:, 0] > 0).all())
    assert bool((count[:, 0] % C.PHYS_STEPS == 0).all())
    assert bool((count[:, 1] <= count[:, 0]).all())


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    lib = _kernel_host.build(tmp_path_factory.mktemp('kernel_host'))
    if lib is None:
        pytest.skip('no host C++ compiler to build the kernel sources')
    return lib


def _hi_states(cuda, task, batch=64, n_steps=3):
    """A hi `task`-TestAll BatchedEnv on the card, its state after a
    reset and `n_steps` steps, and the action it steps with."""
    env = BatchedEnv(f'{task}-TestAll-LoRes4E-v0', fidelity='hi',
                     device=cuda)
    act = torch.arange(batch, device=cuda, dtype=torch.int32) % C.N_ACTIONS
    carry, _ = env.reset(5, batch)
    for _ in range(n_steps):
        carry, *_ = env.step(carry, act)
    torch.cuda.synchronize()
    return env, carry, act


@pytest.mark.parametrize('task', ['MoveToCorner', 'ClusterColour'])
def test_hi_render_kernel_counts_the_prims_it_culls(cuda, host_lib, task):
    """K4's step entry with its counters: the same frame bytes as
    without them; each env's cycles positive in both phases; its kept
    prims at most its active ones; and both counts those of the host
    build of the tile loop on the same states (with the card's cos and
    sin)."""
    env, carry, _ = _hi_states(cuda, task)
    st, spec = carry.state, env.preproc
    args, ss = env._render_args(), env.static_shapes
    B = st.batch
    rings = [{v: torch.zeros((spec.depth(v), B, 96, 96, 3),
                             dtype=torch.uint8, device=cuda)
              for v in spec.views} for _ in range(2)]
    counters = trace.KernelCounters()
    render_kernel.render_hi_into_slots(st, rings[0], 1, *args, spec,
                                       static_shapes=ss)
    render_kernel.render_hi_into_slots(st, rings[1], 1, *args, spec,
                                       static_shapes=ss, counters=counters)
    torch.cuda.synchronize()
    for v in spec.views:
        assert torch.equal(rings[0][v], rings[1][v]), v
    clock, items = (counters.take(name, B, cuda)
                    for name in ('k4_cycles', 'k4_items'))
    assert bool((clock > 0).all())
    active, kept = items.unbind(1)
    assert bool((0 < kept).all() and (kept <= active).all())
    host = st.replace(**{f.name: getattr(st, f.name).cpu()
                         for f in dataclasses.fields(st)})
    prog = render_kernel.program_arrays(*args, ss)
    want = torch.zeros((B, 2), dtype=torch.int64)
    for v in spec.views:
        out = torch.empty((B, 96, 96, 3), dtype=torch.uint8)
        keep = _kernel_host.torch_trig(host_lib, st)
        fields, a = _kernel_host.scene_args(host, prog, out, 96, v, 4)
        assert host_lib.render_hi_into_slot(
            *a, *render_kernel.HI_TILE, None, want.data_ptr(), None,
            None) == 0
        assert host_lib.render_trig_misses() == 0
        del keep, fields
    assert torch.equal(items.cpu(), want)


def test_a_traced_hi_step_counts_k4(cuda):
    """A hi BatchedEnv's steps fill counters()' k4_cycles, k4_items and
    k4_pixels while a profiler records, and leave them at zero otherwise:
    the active prims are each env's active display prims from slot 2 up,
    in each of its 9 blocks and each traced step; the pixels each frame's,
    a few percent of them undecided."""
    from torch.profiler import ProfilerActivity, profile

    env, carry, act = _hi_states(cuda, 'MoveToCorner', n_steps=1)
    zeros = {'k4_cycles': dict.fromkeys(render_kernel.K4_PHASES, 0),
             'k4_items': dict.fromkeys(render_kernel.K4_ITEMS, 0),
             'k4_pixels': dict.fromkeys(render_kernel.K4_PIXELS, 0)}
    assert {k: env.counters()[k] for k in zeros} == zeros
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(2):
            carry, *_ = env.step(carry, act)
        torch.cuda.synchronize()
    counters = env.counters()
    trace.clear()
    assert all(n > 0 for n in counters['k4_cycles'].values())
    disp = render_kernel.kernel_display(carry.state, *env._render_args(),
                                        env.static_shapes)
    items = counters['k4_items']
    assert items['active'] == 2 * 9 * int(disp['active'][:, 2:].sum())
    assert 0 < items['kept'] < items['active']
    pixels = counters['k4_pixels']
    views = len(env.preproc.views)
    assert pixels['pixels'] == 2 * views * carry.state.batch * 96 * 96
    assert 0 < pixels['undecided'] < 0.2 * pixels['pixels']


def _held_actions(batch, steps, seed):
    """(steps, batch) int32 actions: each env holds one of the 18 for 4
    to 16 steps at a time, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    out = np.empty((steps, batch), np.int32)
    for b in range(batch):
        t = 0
        while t < steps:
            n = int(rng.integers(4, 17))
            out[t:t + n, b] = rng.integers(0, C.N_ACTIONS)
            t += n
    return torch.from_numpy(out)


@pytest.mark.parametrize('task', ['MoveToCorner', 'ClusterColour'])
def test_hi_frames_over_whole_episodes_are_the_host_builds(cuda, host_lib,
                                                            task):
    """Whole episodes of `task`-TestAll at hi (30 and 138 prims), 16 envs
    under held random actions: at every 8th step and the last, each step
    frame K4 wrote into the ring is, byte for byte, the host build's frame
    of the same state with the card's cos and sin (the frames the CPU
    tests hold byte for byte to the plain hi render), and the one K4 writes
    with its counters; K4's k4_pixels are the host build's; and the frame
    is within HI_MAX_LEVELS of the plain render on the card."""
    env = BatchedEnv(f'{task}-TestAll-LoRes4E-v0', fidelity='hi',
                     device=cuda)
    spec, args, ss = env.preproc, env._render_args(), env.static_shapes
    prog = render_kernel.program_arrays(*args, ss)
    B, steps = 16, env.max_episode_steps
    acts = _held_actions(B, steps, 11).to(cuda)
    carry, _ = env.reset(11, B)
    checked = 0
    for i in range(steps):
        carry, *_ = env.step(carry, acts[i])
        if (i + 1) % 8 and i + 1 < steps:
            continue
        st, t = carry.state, carry.t
        counters = trace.KernelCounters()
        rings = {v: torch.zeros_like(carry.frames[v]) for v in spec.views}
        render_kernel.render_hi_into_slots(
            st, rings, t, *args, spec, static_shapes=ss, counters=counters)
        torch.cuda.synchronize()
        host = st.replace(**{f.name: getattr(st, f.name).cpu()
                             for f in dataclasses.fields(st)})
        want = torch.zeros((B, 2), dtype=torch.int64)
        for v in spec.views:
            got = carry.frames[v][t % spec.depth(v)]
            assert torch.equal(rings[v][t % spec.depth(v)], got), (i, v)
            out = torch.empty((B, 96, 96, 3), dtype=torch.uint8)
            keep = _kernel_host.torch_trig(host_lib, st)
            fields, a = _kernel_host.scene_args(host, prog, out, 96, v, 4)
            assert host_lib.render_hi_into_slot(
                *a, *render_kernel.HI_TILE, None, None, want.data_ptr(),
                None) == 0
            assert host_lib.render_trig_misses() == 0
            del keep, fields
            assert torch.equal(got.cpu(), out), (i, v)
            _hi_close(got, render.render_views(
                st, *args, views=(v,), fidelity='hi',
                static_shapes=ss)[v])
        assert torch.equal(counters.take('k4_pixels', B, cuda).cpu(),
                           want), i
        checked += 1
    assert checked == steps // 8 + (steps % 8 > 0)


def test_the_port_spans_hold_what_the_benchmark_wraps(cuda, tmp_path):
    """Under the profiler, with the benchmark's layer ranges around the
    entry points (portbench/layers), the ops of each of the port's spans
    are those of the layer range wrapping the same entry point; every op
    of the observation-and-score range is in the observation's or the
    score's span; no idle gap is the layer ranges'; K1 counts cycles in
    every phase."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.harness import spec
    from portbench.harness import trace as layers
    env = BatchedEnv('ClusterColour-TestAll-LoRes4E-v0', device=cuda)
    act = torch.arange(256, device=cuda, dtype=torch.int32) % C.N_ACTIONS
    carry, _ = env.reset(1, 256)
    env.step(carry, act)
    torch.cuda.synchronize()
    trace.clear()
    with layers.wrap(spec.layers(), env):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with layers.span('portbench.reset'):
                carry, _ = env.reset(2, 256)
            for _ in range(3):
                with layers.span('portbench.step'):
                    carry, *_ = env.step(carry, act)
            torch.cuda.synchronize()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    t = layers.read(path)
    for name in ('k1', 'render', 'reset', 'step'):
        ops = [k for k, op in enumerate(t.ops) if f'layer.{name}' in op.ranges]
        assert ops, name
        assert ops == [k for k, op in enumerate(t.ops)
                       if f'magical.{name}' in op.ranges], name
        assert t.device_us((f'layer.{name}',)) == t.device_us(
            (f'magical.{name}',))
    scored = [op for op in t.ops if 'layer.obs_score' in op.ranges]
    assert scored and all('magical.obs' in op.ranges
                          or 'magical.score' in op.ranges for op in scored)
    assert not {label for label, _ in t.gaps} & {
        'layer.reset', 'layer.step', 'layer.k1', 'layer.render'}
    counters = env.counters()
    trace.clear()
    assert (counters['resets'], counters['steps']) == (1, 3)
    # the placement kernel reads nothing back (the plain version read 5
    # times at each of the 10 placements against the robot)
    assert counters['reset_syncs'] == 0
    assert counters['place_items']['drawn'] == 11 * 256 * 128
    assert all(v > 0 for v in counters['k1_cycles'].values()), counters


# ---------------------------------------------------------------------------
# The reset's placement kernel (tasks/place_kernel.py, csrc/place.cu)
# against its plain version on the same CUDA tensors: the benchmark's
# reference resets on the card, and PyTorch's CPU cos and sqrt round apart
# from its CUDA ones in the last ulp on a few inputs, so a reset on the
# card is held to the plain version on the card.
# ---------------------------------------------------------------------------

def _plain_first_fit(props_pos, props_ang, ent_geom, placed, placed_mask,
                     counters=None):
    """randomize.place_from_proposals' test, on any device's tensors."""
    return randomize.first_fit(randomize.proposal_fits(
        props_pos, props_ang, ent_geom, placed, placed_mask))


@pytest.mark.parametrize('family', sorted(ALL_TASKS))
def test_placement_kernel_resets_as_the_plain_version(cuda, monkeypatch,
                                                     family):
    """Every variant of the family that places (TestJitter, TestLayout,
    TestCountPlus, TestAll), at 4096 envs and two seeds: the reset through
    the placement kernel equals, field for field and bit for bit, the same
    reset with the plain version's test on the card."""
    t = ALL_TASKS[family]
    placing = [v for v in t.variants if t.flags_for(v).any_layout]
    assert placing
    for variant in placing:
        for seed in (5, 2 ** 31 + 11):
            def reset():
                return t.reset_fn(torch.Generator().manual_seed(seed), 4096,
                                  t.flags_for(variant), cuda)
            n = place_kernel.first_fit.launches
            got = reset()
            assert place_kernel.first_fit.launches > n
            with monkeypatch.context() as m:
                m.setattr(place_kernel, 'first_fit', _plain_first_fit)
                want = reset()
            for f in dataclasses.fields(want):
                assert torch.equal(getattr(got, f.name),
                                   getattr(want, f.name)), \
                    (variant, seed, f.name)


def test_placement_kernel_counts_its_rounds(cuda, monkeypatch):
    """A ClusterColour-TestAll reset launches the kernel once a placement
    (11: the robot, then 10 blocks); with counters it adds T = 128
    proposals drawn a placement and env, and as tested the rounds of 32
    up to each env's first fit (all 128 where none fits), as the plain
    version's picks in the same reset say; the reset's bits are those of
    the plain version's."""
    t = ALL_TASKS['ClusterColour']
    flags = t.flags_for('TestAll')
    B = 4096
    picks = []

    def recorded(*args, counters=None):
        picks.append(_plain_first_fit(*args))
        return picks[-1]

    monkeypatch.setattr(place_kernel, 'first_fit', recorded)
    plain = t.reset_fn(torch.Generator().manual_seed(3), B, flags, cuda)
    monkeypatch.undo()
    counters = trace.KernelCounters()
    n = place_kernel.first_fit.launches
    st = t.reset_fn(torch.Generator().manual_seed(3), B, flags, cuda,
                    counters=counters)
    assert place_kernel.first_fit.launches == n + 11
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(st, f.name), getattr(plain, f.name))
    assert len(picks) == 11
    tested = sum(torch.where(ok, torch.clamp(32 * (pick // 32 + 1), max=128),
                             128) for pick, ok in picks)
    items = counters.take('place_items', B, cuda)
    assert torch.equal(items[:, 0], torch.full((B,), 11 * 128, device=cuda))
    assert torch.equal(items[:, 1], tested)
    share = float(items[:, 1].sum()) / float(items[:, 0].sum())
    assert 0.25 <= share < 0.5


def test_placement_kernel_holds_the_sweep_on_the_card(cuda):
    """The host tests' adversarial sweep (_kernel_host.placement_cases:
    every pair of entity kinds and every kind against each wall, 64
    proposals a case from a few ulps on one side of contact to a few on
    the other) on the card: each case's first fit and ok from the kernel
    equal the plain test's on the same CUDA tensors, where the first fit
    falls at the contact."""
    n_inside = 0
    for case, args, _ in _kernel_host.placement_cases():
        pos, ang, ent, placed, mask = args
        on = (pos.to(cuda), ang.to(cuda), tuple(x.to(cuda) for x in ent),
              tuple(x.to(cuda) for x in placed), mask.to(cuda))
        pick, ok = place_kernel.first_fit(*on)
        want = _plain_first_fit(*on)
        assert torch.equal(pick, want[0]) and torch.equal(ok, want[1]), case
        n_inside += int(((want[0] > 0) & (want[0] < ang.shape[1] - 1))
                        .sum())
    assert n_inside > 0


def test_placement_kernel_rejects_what_it_does_not_take(cuda):
    B, T = 8, randomize.N_TRIES
    pos = torch.zeros((B, T, 2), device=cuda)
    ang = torch.zeros((B, T), device=cuda)
    geom = base.robot_geom(B, cuda)
    placed = base.Stack(2, B, cuda).placed()
    mask = torch.zeros((B, 0), dtype=torch.bool, device=cuda)
    pick, ok = place_kernel.first_fit(pos, ang, geom, placed, mask)
    assert pick.dtype == torch.int64 and ok.dtype == torch.bool
    with pytest.raises(TypeError):
        place_kernel.first_fit(pos.double(), ang, geom, placed, mask)
    with pytest.raises(ValueError):
        place_kernel.first_fit(pos, ang.cpu(), geom, placed, mask)
    with pytest.raises(ValueError):
        place_kernel.first_fit(pos, ang[:, :5], geom, placed, mask)
    # more placed rows than a warp's staging fits in a block's 48 KB: the
    # launch's error
    E, K, NV = 64, randomize.KSUB, randomize.NV
    many = (torch.zeros((B, E, K, NV, 2), device=cuda),
            torch.zeros((B, E, K), device=cuda),
            torch.ones((B, E, K), dtype=torch.int32, device=cuda),
            torch.zeros((B, E, K), dtype=torch.bool, device=cuda))
    with pytest.raises(RuntimeError, match='place_first_fit'):
        place_kernel.first_fit(pos, ang, geom, many,
                               torch.zeros((B, E), dtype=torch.bool,
                                           device=cuda))


# ---------------------------------------------------------------------------
# The learner on the card against the same work on the CPU.  Float32 with
# TF32 off (the fixture): the convolutions sum in other orders, so outputs
# agree to NET_F32_RTOL of the largest value; bfloat16 to one bfloat16 ulp
# carried through the layers (tests/test_torch_nets.py's tolerance against
# flax).  A first Adam step moves each parameter by lr·g/(|g| + eps), about
# lr·sign(g): where the gradient is within its rounding of 0 the two
# devices may take opposite signs, a difference of up to 2·lr (the card's
# cuDNN sums a weight gradient in another order than the CPU).  So where
# the CPU's gradient is above GRAD_REL of its tensor's largest (over 20x
# the float32 logits' relative difference, 4.4e-5 on the JAX policy) the
# parameters agree to STEP_PARAM_ATOL, 1/15 of the learning rate, and
# elsewhere to the step's bound, 2·lr.
# ---------------------------------------------------------------------------

NET_F32_RTOL = 1e-4
NET_BF16_RTOL = 3e-2
LEARN_LR = 3e-4
GRAD_REL = 1e-3
STEP_PARAM_ATOL = 2e-5


def _obs_act(n, seed=0, res=96):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (n, res, res, 12),
                                          dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 18, n).astype('int32')))


def _assert_step_close(card, cpu):
    """Parameters after one Adam step on each device, the CPU's gradient
    of that step still in .grad (see above)."""
    for (k, a), (_, b) in zip(card.named_parameters(),
                              cpu.named_parameters()):
        d = (a.detach().cpu() - b.detach()).abs()
        g = b.grad.abs()
        sure = g > GRAD_REL * g.max()
        if bool(sure.any()):
            assert float(d[sure].max()) <= STEP_PARAM_ATOL, k
        assert float(d.max()) <= 2 * LEARN_LR + STEP_PARAM_ATOL, k


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_nets_on_the_card_match_the_cpu(cuda, dtype):
    from magical_tpu_torch.models.nets import Discriminator, MagicalCNN
    dt = getattr(torch, dtype)
    rtol = NET_F32_RTOL if dtype == 'float32' else NET_BF16_RTOL
    obs, act = _obs_act(16)
    for cls, args in ((MagicalCNN, (obs,)), (Discriminator, (obs, act))):
        kw = {'with_value_head': True} if cls is MagicalCNN else {}
        cpu = cls(dtype=dt, generator=torch.Generator().manual_seed(0), **kw)
        card = cls(dtype=dt, generator=torch.Generator().manual_seed(0),
                   **kw).to(cuda)
        with torch.no_grad():
            want = cpu(*args)
            got = card(*(a.to(cuda) for a in args))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == torch.float32 and g.device.type == 'cuda'
            assert float((g.cpu() - w).abs().max()) \
                <= rtol * float(w.abs().max())


def test_bc_step_on_the_card_matches_the_cpu(cuda):
    from magical_tpu_torch.train.bc import BCTrainer
    obs, act = _obs_act(32, 1)
    cpu = BCTrainer(obs.shape[1:], lr=LEARN_LR, dtype=torch.float32,
                    device='cpu')
    card = BCTrainer(obs.shape[1:], lr=LEARN_LR, dtype=torch.float32,
                     device=cuda)
    want = cpu.train_step(obs, act)
    got = card.train_step(obs.to(cuda), act.to(cuda))
    assert got['loss'].device.type == 'cuda'
    assert abs(float(got['loss']) - float(want['loss'])) \
        <= NET_F32_RTOL * float(want['loss'])
    _assert_step_close(card.net, cpu.net)


def _gail(device):
    from magical_tpu_torch.train.gail import GAILTrainer
    return GAILTrainer(None, (96, 96, 12), policy_lr=LEARN_LR,
                       disc_lr=LEARN_LR, entropy_coef=0.02,
                       dtype=torch.float32, device=device, disc_freeze_acc=1.0)


def _rollout(device, T=4, B=8):
    import numpy as np
    rng = np.random.default_rng(2)
    obs, _ = _obs_act(T * B, 3)
    tr = {'obs': obs.reshape(T, B, 96, 96, 12),
          'act': torch.from_numpy(rng.integers(0, 18, (T, B)).astype('int32')),
          'logp': torch.from_numpy(-rng.uniform(2, 3.5, (T, B))).float(),
          'value': torch.from_numpy(rng.normal(0, 1, (T, B))).float(),
          'done': torch.zeros(T, B, dtype=torch.bool),
          'reward': torch.from_numpy(rng.normal(0, 1, (T, B))).float(),
          'last_value': torch.from_numpy(rng.normal(0, 1, B)).float()}
    tr['done'][-1] = True
    return {k: v.to(device) for k, v in tr.items()}


def test_ppo_step_on_the_card_matches_the_cpu(cuda):
    cpu, card = _gail('cpu'), _gail(cuda)
    idx = torch.arange(0, 32, 2)
    want = cpu.ppo_update(_rollout('cpu'), idx)
    got = card.ppo_update(_rollout(cuda), idx.to(cuda))
    for k in ('pg', 'vloss', 'entropy'):
        assert abs(float(got[k]) - float(want[k])) \
            <= NET_F32_RTOL * max(abs(float(want[k])), 1.0), k
    _assert_step_close(card.policy, cpu.policy)


def test_disc_update_on_the_card_matches_the_cpu(cuda):
    cpu, card = _gail('cpu'), _gail(cuda)
    exp_obs, exp_act = _obs_act(12, 4)
    idx_p, idx_e = torch.arange(0, 32, 3), torch.arange(0, 12, 2)
    rc = _rollout('cpu')
    want = cpu.disc_update(rc['obs'], rc['act'], idx_p, exp_obs, exp_act,
                           idx_e)
    r = _rollout(cuda)
    got = card.disc_update(r['obs'], r['act'], idx_p.to(cuda),
                           exp_obs.to(cuda), exp_act.to(cuda),
                           idx_e.to(cuda))
    assert float(got['disc_acc']) == float(want['disc_acc'])
    assert abs(float(got['disc_loss']) - float(want['disc_loss'])) \
        <= NET_F32_RTOL * float(want['disc_loss'])
    _assert_step_close(card.disc, cpu.disc)


@pytest.mark.parametrize('render', [True, False])
def test_benchmark_cli_on_the_card(cuda, render, capsys, tmp_path):
    """--json --steps 3, with and without --no-render (which launches no
    render kernel), the latter also writing a torch.profiler trace that
    holds the port's spans of a reset and of the steps."""
    import json
    from magical_tpu_torch.tools import benchmark
    n = render_kernel.render_into_slots.launches
    argv = ['--json', '--steps', '3', '--batch', '256']
    benchmark.main(argv + ([] if render else ['--no-render', '--trace-dir',
                                              str(tmp_path)]))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out['render'] is render and out['steps'] == 3
    assert out['device'] == torch.cuda.get_device_name(0)
    assert out['env_steps_per_s'] > 0 and out['compile_s'] >= 0
    assert (render_kernel.render_into_slots.launches - n == 4) is render
    if not render:
        events = json.loads((tmp_path / 'trace.json').read_text())
        names = {e['name'] for e in events['traceEvents']
                 if e.get('cat') == 'user_annotation'}
        assert {'magical.reset', 'magical.step', 'magical.k1'} <= names


# ---------------------------------------------------------------------------
# the data-parallel path on an NCCL group of one rank, and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def nccl_mesh():
    """A ('data', 'model') mesh over an NCCL group of one rank."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: NCCL runs only there')
    import socket

    import torch.distributed as dist
    from magical_tpu_torch.parallel import mesh as M
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:{port}',
                            world_size=1, rank=0)
    try:
        assert dist.get_backend() == 'nccl'
        yield M.make_mesh()
    finally:
        dist.destroy_process_group()


def test_rollout_episodes_over_nccl_is_batched_envs_rollout(cuda, nccl_mesh):
    from magical_tpu_torch.parallel import rollout as R
    env = BatchedEnv(NAME, device=cuda)
    launches = physics_kernel.control_step.launches
    scores = R.rollout_episodes(env, None, 3, 300, mesh=nccl_mesh)
    assert physics_kernel.control_step.launches - launches == 80
    carry, obs = env.reset(torch.Generator().manual_seed(3), 300)
    gen = torch.Generator(device=cuda).manual_seed(3)
    *_, ref = env.rollout(carry, obs, R.random_policy(300), gen)
    assert scores.device.type == 'cuda' and scores.shape == (300,)
    assert torch.equal(scores, ref[-1])
    assert R.env_throughput(env, 64, n_steps=3, warmup=1) > 0


def test_bc_step_over_nccl_is_the_plain_step(cuda, nccl_mesh):
    """A data-parallel BC step at world size 1 (the gradients all-reduced
    over NCCL) gives the bits of the step with no mesh."""
    from magical_tpu_torch.train.bc import BCTrainer
    obs, act = _obs_act(32, 5)
    obs, act = obs.to(cuda), act.to(cuda)
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for mesh in (None, nccl_mesh):
            tr = BCTrainer(obs.shape[1:], dtype=torch.float32, device=cuda,
                           mesh=mesh)
            m = tr.train_step(obs, act)
            out.append((m, tr.net.state_dict()))
    finally:
        torch.backends.cudnn.deterministic = False
    (m0, p0), (m1, p1) = out
    assert torch.equal(m0['loss'], m1['loss'])
    assert torch.equal(m0['acc'], m1['acc'])
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_cli_records_on_the_card(cuda, tmp_path):
    import os
    import subprocess
    import sys

    from magical_tpu_torch.data.trajectories import load_demos
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, '-m', 'magical_tpu_torch', '--env-name',
         'MoveToRegion-Demo-LoRes4E-v0', '--policy', 'random', '--seed', '0',
         '--record', str(tmp_path)], cwd=root, capture_output=True,
        env=dict(os.environ, PYTHONPATH=root), timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    (name,) = os.listdir(tmp_path)
    (demo,) = load_demos([str(tmp_path / name)])
    assert demo['trajectory'].obs.shape == (41, 96, 96, 12)
    assert len(demo['trajectory'].acts) == 40
    assert demo['score'] in (0.0, 1.0)
