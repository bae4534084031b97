"""The port's own tracing (magical_tpu_torch/trace.py) on the CPU: the
spans a ClusterColour-TestAll reset and step emit under the profiler, each
inside its parent; the counters of that reset (its syncs and the bytes it
draws, computed here from the task's draws); a MoveToCorner-Demo reset
drawing only its seeds; without a profiler, the shared no-op span and
counters that do not move; and tools/benchmark.py's trace holding a reset's
spans and a step's."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from magical_tpu_torch import trace
from magical_tpu_torch.api.batched_env import BatchedEnv
from magical_tpu_torch.core import physics_kernel, render_kernel
from magical_tpu_torch.tasks import ALL_TASKS, base

B = 4
SEED = 2 ** 31 + 77
ZEROS = {'resets': 0, 'steps': 0, 'reset_syncs': 0, 'reset_draw_bytes': 0,
         'k1_cycles': dict.fromkeys(physics_kernel.PHASES, 0),
         'k1_items': dict.fromkeys(physics_kernel.ITEMS, 0),
         'k4_cycles': dict.fromkeys(render_kernel.K4_PHASES, 0),
         'k4_items': dict.fromkeys(render_kernel.K4_ITEMS, 0),
         'k4_pixels': dict.fromkeys(render_kernel.K4_PIXELS, 0)}
# each span: the spans one of which must hold every one of its ranges
# (None: none need)
PARENTS = {
    'magical.step': None,
    'magical.k1': ('magical.step',),
    'magical.render': ('magical.step',),
    'magical.obs': ('magical.step', 'magical.reset.frames'),
    'magical.score': ('magical.step',),
    'magical.reset': None,
    'magical.reset.draw': ('magical.reset',),
    'magical.reset.place': ('magical.reset',),
    'magical.reset.sync': ('magical.reset.place',),
    'magical.reset.render': ('magical.reset',),
    'magical.reset.frames': ('magical.reset',),
}


def ranges(prof, tmp_path):
    """{name: [(start, end)]} of the profile's host ranges."""
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    out = {}
    for e in json.loads(path.read_text())['traceEvents']:
        if e.get('cat') == 'user_annotation':
            out.setdefault(e['name'], []).append(
                (e['ts'], e['ts'] + e.get('dur', 0)))
    return out


@pytest.fixture(scope='module')
def traced(tmp_path_factory):
    """ClusterColour-TestAll: a reset of B envs and one step under the
    profiler: (host ranges, counters, the env)."""
    env = BatchedEnv('ClusterColour-TestAll-LoRes4E-v0', device='cpu')
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        carry, _ = env.reset(SEED, B)
        env.step(carry, torch.arange(B, dtype=torch.int32))
    counters = env.counters()
    trace.clear()
    return ranges(prof, tmp_path_factory.mktemp('trace')), counters, env


def within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize('name', sorted(PARENTS))
def test_a_traced_reset_and_step_emit_every_span_inside_its_parent(
        traced, name):
    spans = traced[0]
    assert set(spans) == set(PARENTS)
    assert spans[name]
    for r in spans[name]:
        assert PARENTS[name] is None or any(
            within(r, p) for parent in PARENTS[name] for p in spans[parent])


def test_a_placement_holds_its_draws(traced):
    """Each of the 11 placements (the robot, then 10 blocks) draws its 128
    proposals inside its span; the other draws are the reset's own."""
    spans = traced[0]
    inside = [d for d in spans['magical.reset.draw']
              if any(within(d, p) for p in spans['magical.reset.place'])]
    assert len(spans['magical.reset.place']) == 11
    assert len(inside) == 2 * 11


def test_a_traced_reset_counts_its_syncs_and_draws(traced):
    _, counters, env = traced

    class Sizes(base.Draws):
        """The task's draws, their host bytes summed: uniforms float32,
        integers int64."""
        nbytes = 0

        def uniform(self, name, shape=()):
            x = super().uniform(name, shape)
            self.nbytes += x.numel() * 4
            return x

        def randint(self, name, low, high, shape=()):
            x = super().randint(name, low, high, shape)
            if not isinstance(high, torch.Tensor):   # else drawn uniform
                self.nbytes += x.numel() * 8
            return x

    d = Sizes(torch.Generator().manual_seed(SEED), B, 'cpu')
    ALL_TASKS['ClusterColour'].reset_from_draws(d, env.flags)
    seeds = B * 2 * 8
    assert counters['resets'] == counters['steps'] == 1
    # 10 blocks placed against a stack that holds the robot: 5 reads each
    # (_entity_overlap: 4 .tolist(), 1 vertex count); the robot's, against
    # an empty stack, reads none
    assert counters['reset_syncs'] == 10 * 5
    assert counters['reset_draw_bytes'] == d.nbytes + seeds
    # 11 placements of 128 proposals (x, y, angle), float32, per env
    assert d.nbytes >= B * 11 * 128 * 3 * 4
    for k in ('k1_cycles', 'k1_items', 'k4_cycles', 'k4_items',
              'k4_pixels'):                                   # CPU: none
        assert counters[k] == ZEROS[k]


def test_a_move_to_corner_demo_reset_draws_only_its_seeds():
    env = BatchedEnv('MoveToCorner-Demo-LoRes4E-v0', render_enabled=False,
                     device='cpu')
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        env.reset(SEED, 4096)
    counters = env.counters()
    trace.clear()
    assert counters == dict(ZEROS, resets=1, reset_draw_bytes=64 * 1024)


def test_without_a_profiler_spans_are_one_no_op_and_nothing_counts():
    env = BatchedEnv('MoveToCorner-TestAll-LoRes4E-v0', device='cpu')
    trace.clear()
    carry, _ = env.reset(SEED, 2)
    env.step(carry, torch.zeros(2, dtype=torch.int32))
    assert env.counters() == ZEROS
    off = trace.span('magical.step')
    assert off is trace.span('magical.reset')
    assert not trace.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.recording()
        assert trace.span('magical.step') is not off


def test_the_benchmark_tool_traces_a_reset_and_the_steps(tmp_path, capsys):
    from magical_tpu_torch.tools import benchmark
    benchmark.main(['--device', 'cpu', '--batch', '2', '--steps', '1',
                    '--json', '--env', 'MoveToCorner-Demo-LoRes4E-v0',
                    '--trace-dir', str(tmp_path)])
    assert json.loads(capsys.readouterr().out)['steps'] == 1
    events = json.loads((tmp_path / 'trace.json').read_text())
    names = {e['name'] for e in events['traceEvents']
             if e.get('cat') == 'user_annotation'}
    assert {'magical.reset', 'magical.reset.frames', 'magical.step',
            'magical.k1', 'magical.render'} <= names
