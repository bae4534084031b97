"""MoveToCorner and MoveToRegion, the two one-entity families, reset
through ``Draws`` and ``base.place`` as the six others do: MoveToCorner's
resets from seeded CPU generators bit for bit those of the benchmark's
frozen copy (``portbench/reference/move_to_corner.py``, which decides the
benchmark's ``reset_gap``), and both families' Test resets on the JAX
package's own random numbers (``_torch_port.jax_draws``, through
``GivenDraws``) value for value the JAX package's.  (Their reset
distributions: tests/test_torch_randomize.py.)"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from magical_tpu_torch.tasks import ALL_TASKS as TT
from magical_tpu_torch.tasks.base import GivenDraws
from portbench.reference import move_to_corner as frozen

from _torch_port import (assert_resets_equal, jax_draws, jax_resets,
                         jax_to_numpy)

B = 8


@pytest.mark.parametrize('variant', TT['MoveToCorner'].variants)
def test_move_to_corner_resets_are_the_frozen_copys_bit_for_bit(variant):
    t = TT['MoveToCorner']
    assert frozen.TASK.variants == t.variants
    for seed in (0, 7, 2 ** 31 + 5):
        port = t.reset_fn(torch.Generator().manual_seed(seed), 64,
                          t.flags_for(variant), 'cpu')
        ref = frozen.TASK.reset_fn(torch.Generator().manual_seed(seed), 64,
                                   frozen.TASK.flags_for(variant), 'cpu')
        for f in dataclasses.fields(port):
            a, b = getattr(port, f.name), getattr(ref, f.name)
            assert a.dtype == b.dtype and torch.equal(a, b), (seed, f.name)


@pytest.mark.parametrize('task,variant', [
    ('MoveToCorner', 'TestJitter'), ('MoveToCorner', 'TestAll'),
    ('MoveToRegion', 'TestLayout'), ('MoveToRegion', 'TestAll')])
def test_test_reset_on_the_references_draws(task, variant):
    t = TT[task]
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    st = t.reset_from_draws(GivenDraws(jax_draws(task, variant, keys), B,
                                       'cpu'), t.flags_for(variant))
    jn = jax_to_numpy(jax_resets(task, variant, B))
    assert_resets_equal(st, jn)
    # the draws did reach the layout: the robot moved from its default
    demo = jax_to_numpy(jax_resets(task, 'Demo', B))
    assert np.abs(jn['pos'][:, 0] - demo['pos'][:, 0]).max() > 1e-3
