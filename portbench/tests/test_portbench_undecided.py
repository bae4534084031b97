"""The reader of K4's pixel counts on fake counters: the share of the hi
render's pixels left undecided by their classes; a program without the
counter (the parent's K4 has none), or one that counted no pixel, reads
nothing; the hi cell reports it, and no lo cell does."""

import types

import pytest

from magical_tpu_torch.api.batched_env import BatchedEnv
from portbench.harness import spec


class Env:
    def __init__(self, **counters):
        self._counters = counters

    def counters(self):
        return self._counters


def read(env):
    ctx = types.SimpleNamespace(env=env, steps=2)
    return spec.load_metric('k4_undecided_share').read(ctx)


def test_the_share_of_pixels_shaded_per_subpixel():
    # 2 steps of 4 envs' 96 x 96 frames, 1,843 pixels left undecided
    env = Env(k4_pixels={'pixels': 2 * 4 * 96 * 96, 'undecided': 1843},
              k4_items={'active': 36, 'kept': 6})
    assert read(env) == pytest.approx(100.0 * 1843 / 73728)
    assert read(Env(k4_pixels={'pixels': 9216, 'undecided': 0})) == 0.0


@pytest.mark.parametrize('env', [
    object(),                                              # no counters
    Env(k4_cycles={'build': 1, 'shade': 3},                # the parent's
        k4_items={'active': 36, 'kept': 6}),
    Env(k4_pixels={'pixels': 0, 'undecided': 0}),          # nothing (lo)
])
def test_without_k4_pixels_it_reads_nothing(env):
    assert read(env) is None


def test_a_cpu_env_counts_no_pixel():
    env = BatchedEnv('MoveToCorner-TestAll-LoRes4E-v0', fidelity='hi',
                     device='cpu')
    assert env.counters()['k4_pixels'] == {'pixels': 0, 'undecided': 0}
    assert read(env) is None


def test_only_the_hi_cell_reports_it():
    metric = spec.load_metric('k4_undecided_share')
    assert (metric.LAYER, metric.UNIT, metric.MOVES) == (
        'render', '%', 'env_steps_per_s')
    for cell in spec.benchmark()['workloads']:
        names = [m['name'] for m in spec.cell(cell['name']).per_layer]
        assert ('k4_undecided_share' in names) == (
            cell['name'] == 'mtc-testall-hi'), cell['name']
