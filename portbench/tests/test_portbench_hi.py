"""The hi evaluation cell `mtc-testall-hi` on the CPU: the harness finds it
by name; the readers of K4's counters (the shading share of its cycles,
the share of active prims its tile cull keeps) hold hand-computed values
and read nothing on a program without the counters; and the port's plain
hi path equals the frozen reference through a whole MoveToCorner-TestAll
episode, past its randomised reset."""

import types

import pytest
import torch

from magical_tpu_torch.api.batched_env import BatchedEnv
from portbench.harness import spec, trace
from portbench.reference.env import Scene
from portbench.tests.test_portbench_reference import assert_same_state, config
from portbench.tests.test_portbench_spans import EVENTS, ev, launch


class Env:
    def __init__(self, **counters):
        self._counters = counters

    def counters(self):
        return self._counters


def read(name, ctx):
    return spec.load_metric(name).read(ctx)


def test_the_hi_cell_is_found_by_name():
    cell = spec.cell('mtc-testall-hi')
    assert cell.env_id == 'MoveToCorner-TestAll-LoRes4E-v0'
    assert (cell.chips, cell.traffic['fidelity'], cell.traffic['batch']) \
        == (1, 'hi', 4096)
    assert cell.config['fidelity'] == cell.traffic['fidelity']
    assert cell.config['variant'] == cell.traffic['variant']
    assert cell.traffic['limits'] == spec.cell('mtc-demo-lo').traffic[
        'limits']
    bench = spec.benchmark()
    unlisted = [m['name'] for m in bench['per_layer']
                if 'workloads' not in m]
    assert [m['name'] for m in cell.per_layer] == unlisted + [
        'k4_shade_ms', 'k4_kept_share']
    assert [m['name'] for m in cell.end_to_end] == [
        m['name'] for m in bench['end_to_end']]


def test_the_share_of_active_prims_k4_keeps():
    # 9 blocks an env, 4 active prims each: 36 counted, 6 kept
    env = Env(k4_items={'active': 36, 'kept': 6},
              k1_items={'candidates': 29, 'tested': 29})
    ctx = types.SimpleNamespace(env=env, steps=1)
    assert read('k4_kept_share', ctx) == pytest.approx(100.0 / 6)


@pytest.mark.parametrize('env', [
    object(),                                        # no counters at all
    Env(k1_items={'candidates': 29, 'tested': 29}),  # the parent's
    Env(k4_items={'active': 0, 'kept': 0}),          # nothing counted (lo)
])
def test_without_k4_items_it_reads_nothing(env):
    ctx = types.SimpleNamespace(env=env, steps=1)
    assert read('k4_kept_share', ctx) is None


# two steps of a hi env: K4 (30 µs, then 50) inside the render span, K1
# outside it
HI_EVENTS = [
    ev('user_annotation', 'portbench.step', 0, 100),
    ev('user_annotation', 'magical.step', 1, 98),
    ev('user_annotation', 'magical.k1', 2, 3),
    ev('user_annotation', 'magical.render', 6, 4),
    ev('user_annotation', 'portbench.step', 200, 100),
    ev('user_annotation', 'magical.step', 201, 98),
    ev('user_annotation', 'magical.render', 206, 4),
    launch(3, 1), launch(7, 2), launch(207, 3),
    ev('kernel', 'control_step_kernel_1', 10, 20, correlation=1),
    ev('kernel', 'render_tiles_kernel_true', 30, 30, correlation=2),
    ev('kernel', 'render_tiles_kernel_true', 210, 50, correlation=3),
]


def test_k4_shade_ms_is_the_render_span_times_the_shading_share():
    env = Env(k4_cycles={'build': 1, 'shade': 3})
    ctx = types.SimpleNamespace(trace=trace.attribute(HI_EVENTS), steps=2,
                                env=env)
    # 80 µs of K4 over 2 steps, 3 of its 4 cycles shading
    assert read('k4_shade_ms', ctx) == pytest.approx(80e-3 / 2 * 3 / 4)


@pytest.mark.parametrize('env', [
    Env(),                                         # the parent's
    Env(k4_cycles={'build': 0, 'shade': 0}),       # nothing counted
])
def test_k4_shade_ms_without_k4_cycles_reads_nothing(env):
    ctx = types.SimpleNamespace(trace=trace.attribute(HI_EVENTS), steps=2,
                                env=env)
    assert read('k4_shade_ms', ctx) is None


def test_k4_shade_ms_without_spans_or_counters_reads_nothing():
    bare = [e for e in EVENTS if not e['name'].startswith('magical.')]
    ctx = types.SimpleNamespace(trace=trace.attribute(bare), steps=1,
                                env=object())
    assert read('k4_shade_ms', ctx) is None


def test_a_whole_hi_episode_past_its_reset():
    """The reset's hi observation; then, for a whole episode of random
    actions, the state, the observation, `done` and the score after each
    step, the episode's last among them."""
    batch = 3
    cfg = config('move-to-corner-hi')
    env_id = f'{cfg["task"]}-TestAll-{cfg["preproc"]}-v0'
    env = BatchedEnv(env_id, fidelity='hi', device='cpu')
    scene = Scene(cfg, 'TestAll', 'hi')
    carry, obs = env.reset(torch.Generator().manual_seed(5), batch)
    ref = scene.reset(torch.Generator().manual_seed(5), batch, 'cpu')
    assert_same_state(carry.state, ref)
    frames = [scene.frames(ref)]
    assert torch.equal(obs, scene.observation(frames))
    actions = torch.Generator().manual_seed(6)
    for _ in range(scene.ep_len):
        act = torch.randint(0, 18, (batch,), generator=actions,
                            dtype=torch.int32)
        carry, obs, _, done, info = env.step(carry, act)
        ref = scene.step(ref, act)
        frames.append(scene.frames(ref))
        assert_same_state(carry.state, ref)
        assert torch.equal(obs, scene.observation(frames))
        want_done = ref.t >= scene.ep_len
        assert torch.equal(done, want_done)
        assert torch.equal(info['eval_score'],
                           torch.where(want_done, scene.score(ref), 0.0))
    assert bool(done.all())
