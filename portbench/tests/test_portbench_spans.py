"""The readers of the port's own spans and counters on a synthetic trace:
the placement's device time without its draws' copies, the idle gaps of
the reset's spans alone, and the counters read through
``ctx.env.counters()``; a program without them reads nothing."""

import types

import pytest

from portbench.harness import spec, trace

NEW = ('reset_place_ms', 'reset_idle_ms', 'reset_syncs', 'reset_draw_mb',
       'k1_narrow_ms')


def ev(cat, name, ts, dur, **args):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
            'tid': 1, 'args': args}


def launch(ts, corr):
    return ev('cuda_runtime', 'cudaLaunchKernel', ts, 1, correlation=corr)


EVENTS = [
    ev('user_annotation', 'portbench.reset', 0, 100),
    ev('user_annotation', 'magical.reset', 1, 97),
    ev('user_annotation', 'magical.reset.place', 5, 55),
    ev('user_annotation', 'magical.reset.draw', 6, 4),
    ev('user_annotation', 'magical.reset.sync', 20, 10),
    ev('user_annotation', 'magical.reset.draw', 62, 8),
    ev('user_annotation', 'magical.reset.render', 72, 8),
    ev('user_annotation', 'portbench.step', 110, 30),
    ev('user_annotation', 'magical.step', 111, 28),
    ev('user_annotation', 'magical.k1', 112, 8),
    launch(8, 1), launch(12, 2), launch(21, 3), launch(65, 4),
    launch(73, 5), launch(113, 6),
    # the proposals' copy: placement, but a draw's
    ev('gpu_memcpy', 'Memcpy HtoD', 15, 5, correlation=1),
    ev('kernel', 'placement_kernel', 20, 20, correlation=2),
    # the sync's read, inside the placement
    ev('gpu_memcpy', 'Memcpy DtoH', 40, 2, correlation=3),
    # the seeds' copy, after 38 µs idle
    ev('gpu_memcpy', 'Memcpy HtoD', 80, 1, correlation=4),
    ev('kernel', 'render_lo_frame', 81, 9, correlation=5),
    # K1, after 60 µs idle that is the step's
    ev('kernel', 'control_step_kernel_10', 150, 20, correlation=6),
]


class Env:
    def counters(self):
        return {'resets': 2, 'steps': 1, 'reset_syncs': 100,
                'reset_draw_bytes': 140_740_000,
                'k1_cycles': {'narrowphase': 3, 'prestep': 2, 'sweep': 4,
                              'apply': 1, 'joints': 1, 'other': 1}}


def read(name, ctx):
    return spec.load_metric(name).read(ctx)


def test_span_readers_hold_hand_computed_values():
    t = trace.attribute(EVENTS)
    ctx = types.SimpleNamespace(trace=t, steps=1, env=Env())
    # placement: the kernel (20 µs) and the sync's read (2), not the
    # draw's copy (5); over 2 resets
    assert read('reset_place_ms', ctx) == pytest.approx(22 / 2 / 1e3)
    # idle: 0-15 and 42-80, both ended by a draw's copy; not the 60 µs
    # before K1
    assert dict(t.gaps)['magical.k1'] == 60
    assert read('reset_idle_ms', ctx) == pytest.approx((15 + 38) / 2 / 1e3)
    assert read('reset_syncs', ctx) == 50
    assert read('reset_draw_mb', ctx) == pytest.approx(70.37)
    # 20 µs of K1 in one step, 3 of its 12 cycles the narrowphase's
    assert read('k1_narrow_ms', ctx) == pytest.approx(20e-3 * 3 / 12)


@pytest.mark.parametrize('name', NEW)
def test_a_program_without_spans_or_counters_reads_nothing(name):
    bare = [e for e in EVENTS if not e['name'].startswith('magical.')]
    ctx = types.SimpleNamespace(trace=trace.attribute(bare), steps=1,
                                env=object())
    assert read(name, ctx) is None
