"""The reset's placement on the GPU: the wrapper of ``csrc/place.cu``.

The kernel replaces no Pallas kernel: the JAX package places with XLA ops
(``magical_tpu/tasks/randomize.py``).  It computes the proposal test of
the plain version, :func:`randomize.place_from_proposals`, which tests
every one of an env's ``N_TRIES`` proposals against every placed entity
and then takes the first that fits; the kernel, one warp an env, tests 32
proposals a round and stops at the round that holds the first fit.  The
proposals, their cosines and sines, and the pose taken from the pick stay
in PyTorch (``base.place`` composes :func:`randomize.proposals`,
:func:`first_fit` and :func:`randomize.take`), so the poses are the plain
version's bits wherever the picks are; the source note in the ``.cu``
file says what bounds the kernel.
"""

from __future__ import annotations

import torch

from magical_tpu_torch import _build, trace
from magical_tpu_torch.tasks import randomize as R

# What the kernel counts of each placement, per env: the proposals drawn,
# and those it tested (whole rounds of 32, to the one with the first fit).
ITEMS = ('drawn', 'tested')
trace.declare('place_items', ITEMS)


def _checked(x: torch.Tensor, name: str, dtype, shape, device):
    """`x` as the kernel takes it: contiguous, of `dtype` and `shape`, on
    `device`; raises otherwise."""
    if x.device != device:
        raise ValueError(f'{name} is on {x.device}, the proposals on '
                         f'{device}')
    if x.dtype != dtype:
        raise TypeError(f'{name} has dtype {x.dtype}, kernel takes {dtype}')
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(x.shape)}, kernel takes '
                         f'{tuple(shape)}')
    return x.contiguous()


def first_fit(props_pos, props_ang, ent_geom, placed, placed_mask,
              counters: trace.KernelCounters | None = None):
    """Each env's first proposal that fits (:func:`randomize.proposal_fits`)
    and whether one does: (pick (B,) int64, ok (B,) bool), the pick T - 1
    where none does.  On CUDA tensors one launch of the kernel, which adds
    each env's proposals drawn and tested to `counters`' ``place_items``
    where given; on CPU tensors the plain version, which counts nothing."""
    dev = props_pos.device
    if dev.type == 'cpu':
        return R.first_fit(R.proposal_fits(props_pos, props_ang, ent_geom,
                                           placed, placed_mask))
    if dev.type != 'cuda':
        raise ValueError(f'placement kernel needs CUDA tensors, got {dev}')
    B, T = props_ang.shape
    E = placed_mask.shape[1]
    K, NV = R.KSUB, R.NV
    f, i, b = torch.float32, torch.int32, torch.bool
    pos = _checked(props_pos, 'props_pos', f, (B, T, 2), dev)
    ang = _checked(props_ang, 'props_ang', f, (B, T), dev)
    ent = [_checked(x, f'ent_geom[{k}]', dt, (B,) + shp, dev)
           for k, (x, dt, shp) in enumerate(zip(
               ent_geom, (f, f, i, b), ((K, NV, 2), (K,), (K,), (K,))))]
    rows = [_checked(x, f'placed[{k}]', dt, (B, E) + shp, dev)
            for k, (x, dt, shp) in enumerate(zip(
                placed, (f, f, i, b), ((K, NV, 2), (K,), (K,), (K,))))]
    mask = _checked(placed_mask, 'placed_mask', b, (B, E), dev)
    cos, sin = torch.cos(ang), torch.sin(ang)
    pick = torch.empty((B,), dtype=torch.int64, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    count = None if counters is None else counters.take('place_items', B,
                                                        dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.library().place_first_fit(
        *[x.data_ptr() for x in [pos, cos, sin, *ent, *rows, mask, pick,
                                 ok]],
        None if count is None else count.data_ptr(), B, T, E, stream)
    _build.check(rc, 'place_first_fit')
    first_fit.launches += 1
    return pick, ok


first_fit.launches = 0
