"""The traced run's ranges and the reading of its device trace.

Each ``layers/*.json`` names a layer's range and the port's entry points
that make it up.  :func:`wrap` puts each entry point, at run time, inside
a ``torch.profiler.record_function`` range named ``layer.<range>``; the
harness's own calls run inside ``portbench.<what>`` ranges.  A device
operation belongs to the ranges that were open on the host when it was
launched, and to the step of the window whose ``portbench.step`` range
launched it.

:func:`read` takes the profiler's chrome trace apart: the device
operations (kernels, copies, sets) with their ranges, the union of their
intervals, and the idle gaps between them, each labelled by the innermost
range the host was in when it launched the operation that ended the gap.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import importlib
import json

import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')


def span(name):
    """A host range of the trace."""
    return torch.profiler.record_function(name)


def _ranged(fn, name):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _target(path: str, env):
    """The objects along an entry point's path, outermost first, and the
    attribute names between them: ``module:Attr.attr`` or
    ``env:attr.attr`` (an attribute of the env under test)."""
    where, attr = path.split(':')
    names = attr.split('.')
    chain = [env if where == 'env' else importlib.import_module(where)]
    for name in names[:-1]:
        chain.append(getattr(chain[-1], name))
    return chain, names


@contextlib.contextmanager
def wrap(layers: list, env):
    """Every entry point of `layers` inside its layer's range, while the
    block runs.  An attribute of a frozen dataclass (the env's task) is
    set on a copy of it."""
    undo = []
    try:
        for layer in layers:
            for path in layer['wrap']:
                chain, names = _target(path, env)
                owner, last = chain[-1], names[-1]
                new = _ranged(getattr(owner, last),
                              f'layer.{layer["range"]}')
                if dataclasses.is_dataclass(owner) and not isinstance(
                        owner, type):
                    # a frozen dataclass: a copy with the wrapped field
                    owner, last = chain[-2], names[-2]
                    new = dataclasses.replace(chain[-1],
                                              **{names[-1]: new})
                undo.append((owner, last, getattr(owner, last)))
                setattr(owner, last, new)
        yield
    finally:
        for owner, name, old in reversed(undo):
            setattr(owner, name, old)


@dataclasses.dataclass
class Op:
    """A device operation: name, start and duration in µs, the ranges open
    when it was launched (outermost first), and the window's step."""
    name: str
    start: float
    dur: float
    ranges: tuple
    step: int


@dataclasses.dataclass
class Trace:
    ops: list                 # Op, by start
    window: tuple             # (start, end) in µs
    busy_us: float            # union of the ops' intervals in the window
    gaps: list                # (label, µs), each idle gap

    @property
    def window_us(self):
        return self.window[1] - self.window[0]

    def device_us(self, has, hasnt=()):
        """Device time of the ops inside every range of `has` and none of
        `hasnt`."""
        return sum(op.dur for op in self.ops
                   if all(r in op.ranges for r in has)
                   and not any(r in op.ranges for r in hasnt))

    def by_step(self, has):
        """{step: device µs} of the ops inside `has`."""
        out = collections.Counter()
        for op in self.ops:
            if has in op.ranges:
                out[op.step] += op.dur
        return out


def read(path) -> Trace:
    """The trace of ``export_chrome_trace`` at `path`."""
    events = json.loads(open(path).read())['traceEvents']
    return attribute(events)


def attribute(events: list) -> Trace:
    """Device operations of chrome-trace `events` with their host ranges.
    The window runs from the start of the first ``portbench.`` range to
    the end of the last device operation."""
    ranges = sorted(((e['ts'], e['ts'] + e.get('dur', 0), e['name'],
                      e.get('tid')) for e in events
                     if e.get('ph') == 'X'
                     and e.get('cat') == 'user_annotation'),
                    key=lambda r: (r[0], -r[1]))
    launch = {}
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') in LAUNCH_CATS:
            corr = (e.get('args') or {}).get('correlation')
            if corr is not None:
                launch[corr] = (e['ts'], e.get('tid'))
    device = sorted((e for e in events if e.get('ph') == 'X'
                     and e.get('cat') in DEVICE_CATS),
                    key=lambda e: e['ts'])
    # each op's launch on the host, in time order, swept against the
    # ranges in order of their start, a stack of the open ones per thread
    found = []
    for k, e in enumerate(device):
        ts, tid = launch.get((e.get('args') or {}).get('correlation'),
                             (None, None))
        if ts is not None:
            found.append((ts, tid, k))
    found.sort(key=lambda x: x[0])
    where = [((), 0)] * len(device)
    stacks = collections.defaultdict(list)
    i, steps = 0, 0
    for ts, tid, k in found:
        while i < len(ranges) and ranges[i][0] <= ts:
            r = ranges[i]
            stack = stacks[r[3]]
            while stack and stack[-1][1] < r[0]:
                stack.pop()
            stack.append(r)
            steps += r[2] == 'portbench.step'
            i += 1
        stack = stacks[tid]
        while stack and stack[-1][1] < ts:
            stack.pop()
        names = tuple(r[2] for r in stack if r[1] >= ts)
        where[k] = (names, steps if 'portbench.step' in names else 0)
    ops = [Op(e['name'], float(e['ts']), float(e.get('dur', 0)), *where[k])
           for k, e in enumerate(device)]
    host = [r[0] for r in ranges if r[2].startswith('portbench.')]
    return timeline(ops, min(host, default=None))


def timeline(ops: list, lo) -> Trace:
    """The trace of `ops` (by start) over the window from `lo` to the end
    of the last op: the union of their intervals, and each idle gap
    labelled by the innermost range of the op that ended it."""
    if not ops or lo is None:
        return Trace(ops=ops, window=(0.0, 0.0), busy_us=0.0, gaps=[])
    hi = max(op.start + op.dur for op in ops)
    busy, gaps, end = 0.0, [], lo
    for op in ops:
        a, b = max(op.start, lo), min(op.start + op.dur, hi)
        if b <= a:
            continue
        if a > end:
            label = op.ranges[-1] if op.ranges else 'outside the ranges'
            gaps.append((label, a - end))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return Trace(ops=ops, window=(lo, hi), busy_us=busy, gaps=gaps)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by kernel name, and the
    idle time by what the host was launching when it ended, in seconds."""
    ops = collections.Counter()
    for op in trace.ops:
        ops[op.name] += op.dur
    gaps = collections.Counter()
    for label, us in trace.gaps:
        gaps[label] += us
    return {'device_ops': [[n, us / 1e6] for n, us in ops.most_common(top)],
            'idle_gaps': [[n, us / 1e6] for n, us in gaps.most_common(top)]}
