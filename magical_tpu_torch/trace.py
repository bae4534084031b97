"""The port's own host ranges and counters, on exactly while a
``torch.profiler`` records and off otherwise, with no flag of their own.

:func:`span` opens a ``torch.profiler.record_function`` range, which lands
in the profiler's trace beside the device's kernels and copies, on the
same clock; a device operation belongs to the ranges open on the host
when it was launched.  Off, it returns one shared no-op context, after a
check that costs a fraction of a microsecond.  The spans:

    magical.step          BatchedEnv.step, its whole body
    magical.k1            physics_kernel.control_step (kernel or plain)
    magical.render        the step's frames: render_into_slots,
                          render_hi_into_slots, a raw ID's fresh frames
    magical.obs           preproc.observation_cf
    magical.score         the step's `done`, score_fn and `where`
    magical.reset         BatchedEnv.reset, its whole body
    magical.reset.draw    a reset's host draw and its copy to the device
                          (randomize.draw), inside `place` where a
                          placement draws
    magical.reset.place   a placement (base.place, randomize.place_entity)
    magical.reset.sync    a device-to-host read of a placement
    magical.reset.render  the reset's fresh frames (K3, K4)
    magical.reset.frames  the reset's frame rings and first observation

:func:`count` adds to the registry below, also only while a profiler
records: ``resets``, ``steps``, ``reset_syncs`` (device-to-host reads in
resets) and ``reset_draw_bytes`` (bytes a reset drew on the host for its
device).  ``BatchedEnv.counters()`` returns it with the env's kernel
counters, which its step hands the kernels while a profiler records:
``k1_cycles`` (K1's cycles per phase), ``k1_items`` (its narrowphase's
items and those tested in full), ``k4_cycles`` (K4's cycles building and
culling, and shading), ``k4_items`` (K4's active prims and those its
tile cull kept) and ``k4_pixels`` (K4's pixels and those it shaded per
subpixel).  The kernel wrappers' ``.launches`` count always, apart.
"""

from __future__ import annotations

import contextlib

import torch

# True exactly while a torch.profiler records
recording = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()

KEYS = ('resets', 'steps', 'reset_syncs', 'reset_draw_bytes')
_counts = dict.fromkeys(KEYS, 0)


def span(name: str):
    """A host range named `name` while a profiler records; else the shared
    no-op context."""
    if recording():
        return torch.profiler.record_function(name)
    return _OFF


def count(key: str, n: int = 1):
    """Add `n` to counter `key` while a profiler records."""
    if recording():
        _counts[key] += n


def counts() -> dict:
    """The registry: every counter of :data:`KEYS`, over every env of the
    process."""
    return dict(_counts)


def clear():
    """Set every counter to 0."""
    for key in KEYS:
        _counts[key] = 0
