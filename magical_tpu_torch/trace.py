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
    magical.reset.place   a placement (base.place)
    magical.reset.sync    a device-to-host read of a placement (the
                          plain version's, on the CPU; the card's
                          placement kernel reads nothing back)
    magical.reset.render  the reset's fresh frames (K3, K4)
    magical.reset.frames  the reset's frame rings and first observation

:func:`count` adds to the registry below, also only while a profiler
records: ``resets``, ``steps``, ``reset_syncs`` (device-to-host reads in
resets) and ``reset_draw_bytes`` (bytes a reset drew on the host for its
device).  ``BatchedEnv.counters()`` returns it with the totals of the
env's :class:`KernelCounters`, which its step hands the kernels while a
profiler records.  Each kernel's module declares the counters its kernel
keeps (:func:`declare`), beside the kernel: ``core/physics_kernel.py``
K1's, ``core/render_kernel.py`` K4's, ``tasks/place_kernel.py`` the
reset's placement's.  The kernel wrappers' ``.launches``
count always, apart.
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


# {name: field names}: every kernel counter, declared at import by the
# module of its kernel
_KERNEL_COUNTERS = {}


def declare(name: str, fields):
    """Declare kernel counter `name`: int64 counts of `fields` per env."""
    _KERNEL_COUNTERS[name] = tuple(fields)


class KernelCounters:
    """The kernel counters of one owner on its device: for each declared
    counter and batch size it was taken at, an int64 (B, len(fields))
    tensor that the kernels add to."""

    def __init__(self):
        self._tensors = {}         # (name, batch) -> tensor

    def take(self, name: str, batch: int, device) -> torch.Tensor:
        """Counter `name`'s tensor for `batch` envs, made on `device` with
        zeros when first taken, the same tensor after that."""
        key = (name, batch)
        if key not in self._tensors:
            self._tensors[key] = torch.zeros(
                (batch, len(_KERNEL_COUNTERS[name])), dtype=torch.int64,
                device=device)
        return self._tensors[key]

    def totals(self) -> dict:
        """{name: {field: count summed over envs and batches}} of every
        declared counter, zeros where never taken: read from the device,
        so it syncs."""
        out = {name: dict.fromkeys(fields, 0)
               for name, fields in _KERNEL_COUNTERS.items()}
        for (name, _), x in self._tensors.items():
            for field, n in zip(_KERNEL_COUNTERS[name], x.sum(0).tolist()):
                out[name][field] += n
        return out
