"""The harness on the CPU: the window's arithmetic, the trace's reading on
synthetic timelines, the look for a card, what the harness finds by name,
and what the benchmark's modules import."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import spec, trace, window

HERE = spec.HERE
ROOT = HERE.parent


def test_rate_and_p95_count_every_step_and_reset():
    # a reset of 50 ms, then 99 steps of 2 ms, then a reset of 40 ms and
    # 99 steps of 3 ms: 198 steps of 10 envs
    marks = [0.0]
    for reset, step in ((50.0, 2.0), (40.0, 3.0)):
        marks.append(marks[-1] + reset)
        marks += [marks[-1] + step * (k + 1) for k in range(99)]
    w = window.Window(marks_ms=marks, resets=2, steps=198, batch=10,
                      episodes=[])
    assert w.seconds == pytest.approx((50 + 40 + 99 * 5) / 1e3)
    assert window.env_steps_per_s(w) == pytest.approx(
        10 * 198 / ((50 + 40 + 99 * 5) / 1e3))
    assert len(w.intervals_ms) == 200
    # 10 of 200 intervals are 3 ms or more: 2 resets and the 3 ms steps
    # start at rank 101; the 95th percentile lies among the 3 ms steps
    assert window.step_ms_p95(w) == pytest.approx(3.0)
    # one stalled step stays above the tail; twelve move it
    for stalls, p95 in ((1, 3.0), (12, 1003.0)):
        gaps = w.intervals_ms
        gaps[-stalls:] = [g + 1000.0 for g in gaps[-stalls:]]
        stalled = window.Window([0.0] + [sum(gaps[:k + 1]) for k in range(
            len(gaps))], 2, 198, 10, [])
        assert window.step_ms_p95(stalled) == pytest.approx(p95)


def ev(cat, name, ts, dur, **args):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
            'tid': 1, 'args': args}


def test_idle_is_the_union_and_kernels_land_in_their_ranges():
    events = [
        ev('user_annotation', 'portbench.reset', 0, 10),
        ev('user_annotation', 'portbench.step', 20, 30),
        ev('user_annotation', 'layer.step', 21, 28),
        ev('user_annotation', 'layer.k1', 22, 5),
        ev('user_annotation', 'layer.render', 30, 5),
        ev('cuda_runtime', 'cudaLaunchKernel', 2, 1, correlation=1),
        ev('cuda_runtime', 'cudaLaunchKernel', 23, 1, correlation=2),
        ev('cuda_runtime', 'cudaLaunchKernel', 31, 1, correlation=3),
        ev('cuda_runtime', 'cudaMemcpyAsync', 40, 1, correlation=4),
        ev('kernel', 'reset_kernel', 5, 10, correlation=1),
        ev('kernel', 'physics_k1', 30, 20, correlation=2),
        # overlaps the first 10 µs of physics_k1: counted once
        ev('kernel', 'render_lo', 40, 20, correlation=3),
        ev('gpu_memcpy', 'Memcpy HtoD', 70, 10, correlation=4),
    ]
    t = trace.attribute(events)
    assert t.window == (0, 80)
    assert t.busy_us == pytest.approx(10 + 30 + 10)   # 5-15, 30-60, 70-80
    assert t.device_us(('layer.k1',)) == 20
    assert t.device_us(('layer.render',)) == 20
    assert t.device_us(('layer.step',), ('layer.k1',)) == 20 + 10
    assert t.by_step('layer.k1') == {1: 20}
    gaps = dict(t.gaps)
    assert gaps['portbench.reset'] == 5              # 0-5, before the reset
    assert gaps['layer.k1'] == 15                    # 15-30
    assert gaps['layer.step'] == 10                  # 60-70, the copy
    b = trace.breakdown(t)
    assert b['device_ops'][0] == ['physics_k1', 20e-6]


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'mtc-demo-lo',
         '--seed', str(2 ** 31 + 5), '--seconds', '1', '--trace', '0'],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'CUDA' in out.stderr


def test_a_new_config_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    here = tmp_path / HERE.name
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        '__pycache__'))
    bench = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    cfg = json.loads((here / 'configs' / 'move-to-corner.json').read_text())
    cfg['name'] = 'move-to-region'
    cfg['task'] = 'MoveToRegion'
    (here / 'configs' / 'move-to-region.json').write_text(json.dumps(cfg))
    tr = json.loads((here / 'traffic' / 'mtc-demo-lo.json').read_text())
    tr['variant'] = 'TestJitter'
    (here / 'traffic' / 'mtr-jitter-lo.json').write_text(json.dumps(tr))
    (here / 'metrics' / 'resets_a_s.py').write_text(
        'LAYER = "reset and placement"\nUNIT = "1/s"\n'
        'MOVES = "env_steps_per_s"\n\n\ndef read(ctx):\n'
        '    return 1e3 / ctx.reset_ms\n')
    (here / 'layers' / 'native.json').write_text(json.dumps(
        {'layer': 'native', 'range': 'native', 'wrap': []}))
    bench['configs'].append({'name': 'move-to-region', 'source': 'x',
                             'file': 'portbench/configs/move-to-region.json',
                             'reduced': [], 'why': 'x'})
    bench['workloads'].append({'name': 'mtr-jitter-lo',
                               'config': 'move-to-region',
                               'traffic': 'mtr-jitter-lo', 'chips': 1,
                               'why': 'x'})
    bench['per_layer'].append({'name': 'resets_a_s', 'unit': '1/s',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'reset and placement',
                               'moves': 'env_steps_per_s'})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    cell = spec.cell('mtr-jitter-lo', root=tmp_path)
    assert cell.env_id == 'MoveToRegion-TestJitter-LoRes4E-v0'
    assert [m['name'] for m in cell.per_layer][-1] == 'resets_a_s'
    assert spec.load_metric('resets_a_s', here).read(
        type('ctx', (), {'reset_ms': 250.0})) == 4.0
    assert 'native' in [layer['range'] for layer in spec.layers(here)]
    # the cells already there are found as before
    assert spec.cell('mtc-demo-lo', root=tmp_path).traffic == json.loads(
        (HERE / 'traffic' / 'mtc-demo-lo.json').read_text())


def imports(path):
    """Top-level names of every module `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


@pytest.mark.parametrize('path', sorted(
    p.relative_to(HERE).as_posix() for p in HERE.rglob('*.py')))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = imports(HERE / path)
    assert not names & {'jax', 'jaxlib', 'flax', 'magical_tpu'}
    if path.split('/')[0] in ('reference', 'work', 'metrics'):
        assert 'magical_tpu_torch' not in names
    if path.startswith('tests/'):
        return
    assert 'chip_smoke' not in names and 'bench' not in names


def test_metric_readers_agree_with_the_benchmark():
    from portbench.harness import learner
    bench = spec.benchmark()
    layers = {layer['layer'] for layer in spec.layers()} | {'device'} | set(
        learner.LAYERS)
    for m in bench['per_layer']:
        reader = spec.load_metric(m['name'])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
            m['layer'], m['unit'], m['moves'])
        assert m['layer'] in layers


def test_layers_wrap_the_port_entry_points_and_unwrap(tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.core import physics_kernel
    env = BatchedEnv('MoveToCorner-Demo-LoRes4E-v0', device='cpu')
    before = (physics_kernel.control_step, env.task, BatchedEnv.step)
    with trace.wrap(spec.layers(), env):
        assert env.task.score_fn is not before[1].score_fn
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            carry, _ = env.reset(1, 2)
            env.step(carry, torch.zeros(2, dtype=torch.int32))
    assert (physics_kernel.control_step, env.task, BatchedEnv.step) == before
    prof.export_chrome_trace(str(tmp_path / 't.json'))
    names = {e['name'] for e in json.loads((tmp_path / 't.json').read_text())
             ['traceEvents'] if e.get('cat') == 'user_annotation'}
    assert {f'layer.{layer["range"]}' for layer in spec.layers()} <= names


def test_every_end_to_end_metric_is_a_quantity_the_window_measures():
    for m in spec.benchmark()['end_to_end']:
        assert m['name'] in (
            'env_steps_per_s', 'step_ms_p95', 'train_samples_per_s',
            'setup_s')
    for w in spec.benchmark()['workloads']:
        cell = spec.cell(w['name'])
        moved = {m['moves'] for m in cell.per_layer}
        assert moved <= {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in {m['name'] for m in cell.end_to_end}
