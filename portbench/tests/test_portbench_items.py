"""The reader of K1's narrowphase item counts on fake counters: the share
of items tested in full; a program without the counter, or one that
counted no item, reads nothing."""

import types

import pytest

from portbench.harness import spec


class Env:
    def __init__(self, **counters):
        self._counters = counters

    def counters(self):
        return self._counters


def read(env):
    ctx = types.SimpleNamespace(env=env, steps=1)
    return spec.load_metric('k1_tested_share').read(ctx)


def test_the_share_of_items_tested_in_full():
    env = Env(steps=3, k1_items={'candidates': 3050, 'tested': 61})
    assert read(env) == pytest.approx(2.0)
    env = Env(k1_items={'candidates': 290, 'tested': 290})
    assert read(env) == pytest.approx(100.0)


@pytest.mark.parametrize('env', [
    object(),                                      # no counters at all
    Env(steps=3, k1_cycles={'narrowphase': 5}),    # counters, not items
    Env(k1_items={'candidates': 0, 'tested': 0}),  # nothing counted
])
def test_without_the_counter_it_reads_nothing(env):
    assert read(env) is None
