"""The reader of the placement kernel's proposal counts on fake counters:
the share of drawn proposals tested; a program without the counter, or
one that placed nothing, reads nothing."""

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
    return spec.load_metric('reset_tested_share').read(ctx)


def test_the_share_of_proposals_tested():
    env = Env(resets=2, place_items={'drawn': 2 * 11 * 128,
                                     'tested': 2 * 11 * 32})
    assert read(env) == pytest.approx(25.0)
    env = Env(place_items={'drawn': 256, 'tested': 256})
    assert read(env) == pytest.approx(100.0)


@pytest.mark.parametrize('env', [
    object(),                                       # no counters at all
    Env(resets=1, reset_syncs=50),                  # counters, not items
    Env(place_items={'drawn': 0, 'tested': 0}),     # nothing placed
])
def test_without_the_counter_it_reads_nothing(env):
    assert read(env) is None
