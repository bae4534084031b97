"""The kernel counters' container (magical_tpu_torch/trace.py
``KernelCounters``) on the CPU: each kernel module declares its counters;
a counter taken is a zeroed int64 (B, fields) tensor, the same tensor when
taken again; ``totals()`` sums each over envs and batch sizes, with zeros
for every declared counter never taken."""

import torch

from magical_tpu_torch import trace
from magical_tpu_torch.core import physics_kernel, render_kernel
from magical_tpu_torch.tasks import place_kernel

DECLARED = {'k1_cycles': physics_kernel.PHASES,
            'k1_items': physics_kernel.ITEMS,
            'k4_cycles': render_kernel.K4_PHASES,
            'k4_items': render_kernel.K4_ITEMS,
            'k4_pixels': render_kernel.K4_PIXELS,
            'place_items': place_kernel.ITEMS}


def test_the_kernel_modules_declare_their_counters():
    assert trace.KernelCounters().totals() == {
        name: dict.fromkeys(fields, 0) for name, fields in DECLARED.items()}


def test_a_counter_taken_is_one_int64_tensor_a_batch_size():
    counters = trace.KernelCounters()
    for name, fields in DECLARED.items():
        x = counters.take(name, 3, 'cpu')
        assert x.dtype == torch.int64 and x.shape == (3, len(fields))
        assert x.is_contiguous() and not x.any()
        assert counters.take(name, 3, 'cpu') is x
        assert counters.take(name, 5, 'cpu').shape == (5, len(fields))
    counters.take('k1_items', 3, 'cpu')[:] = torch.tensor([[1, 2]] * 3)
    counters.take('k1_items', 5, 'cpu')[0] = torch.tensor([10, 20])
    counters.take('k4_pixels', 5, 'cpu')[4, 1] = 7
    want = {name: dict.fromkeys(fields, 0)
            for name, fields in DECLARED.items()}
    want['k1_items'] = {'candidates': 13, 'tested': 26}
    want['k4_pixels'] = {'pixels': 0, 'undecided': 7}
    assert counters.totals() == want
    assert trace.KernelCounters().totals() == {
        name: dict.fromkeys(fields, 0) for name, fields in DECLARED.items()}
