"""Device meshes and the rank's share of a batch.

The counterpart of ``magical_tpu/parallel/mesh.py``.  The ranks of the
process group form a ``('data', 'model')`` ``DeviceMesh``: envs and
learner batches split along ``data`` (each rank holds its rows as a plain
tensor; its gradients are summed over the ``data`` group), and
MagicalCNN's ``fc`` layer may split its output columns over ``model``
(the one parameter the JAX package annotates, ``nets.py:42-43``).
Everything else is replicated.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1):
    """A ``DeviceMesh`` of every rank of the (initialised) process group,
    shaped (ranks // model_parallel, model_parallel) with dims
    ``('data', 'model')``, on the card under NCCL and on the CPU under
    gloo.  `n_devices`, where given, must be the group's size."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            'make_mesh needs a process group: call '
            'parallel.multihost.initialize (or '
            'torch.distributed.init_process_group) first')
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f'n_devices={n_devices}, but the group has {n} '
                         'ranks: a mesh takes every rank')
    if n % model_parallel:
        raise ValueError(f'{n} ranks do not split into model_parallel='
                         f'{model_parallel}')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return init_device_mesh(device_type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=('data', 'model'))


def data_sharding(mesh):
    """The placements of a batch-axis tensor: rows split over ``data``,
    replicated over ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0), Replicate())


def replicated(mesh):
    from torch.distributed.tensor import Replicate
    return (Replicate(), Replicate())


def data_size(mesh) -> int:
    """The number of ``data`` ranks: 1 with no mesh."""
    return 1 if mesh is None else mesh['data'].size()


def data_rank(mesh) -> int:
    """This rank's index along ``data``: 0 with no mesh."""
    return 0 if mesh is None else mesh['data'].get_local_rank()


def data_rows(mesh, global_batch: int):
    """(local, start): this rank's rows of a global batch along ``data``;
    the whole batch where there is no mesh or it does not divide."""
    n = data_size(mesh)
    if global_batch % n:
        return global_batch, 0
    local = global_batch // n
    return local, local * data_rank(mesh)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh):
    """This rank's rows of every leaf (tensor or numpy array) of a batched
    tree, along ``data``; a leaf whose leading axis does not divide by the
    data ranks passes through whole (as the JAX package leaves such
    batches unsharded).  With no mesh, the whole tree."""
    n, r = data_size(mesh), data_rank(mesh)

    def rows(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim == 0 \
                or x.shape[0] % n:
            return x
        local = x.shape[0] // n
        return x[r * local:(r + 1) * local]
    return _tree_map(rows, tree)


def model_split(mesh) -> bool:
    """Whether `mesh` splits over ``model`` (more than one rank there)."""
    return mesh is not None and mesh['model'].size() > 1


def param_sharding(mesh, module):
    """{parameter name: placements over ('data', 'model')}: a MagicalCNN's
    ``fc`` weight and bias split by output column over ``model`` once
    ``split_fc`` has run (``fc.kernel``'s ``(None, 'model')`` in flax's
    (in, out) layout); everything else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    split = getattr(module, 'fc_split', False)
    return {name: (Replicate(), Shard(0) if split and name.startswith('fc.')
                   else Replicate())
            for name, _ in module.named_parameters()}


def sum_over_data(tensors, mesh):
    """Sum each tensor (a DTensor: its local shard) over the ``data`` ranks
    in place, by one ``all_reduce`` of their concatenation: the same sum,
    bit for bit, on every rank.  With no mesh, nothing to do."""
    local = [t.to_local() if hasattr(t, 'to_local') else t for t in tensors]
    if mesh is None or not local:
        return
    flat = torch.cat([t.reshape(-1) for t in local])
    dist.all_reduce(flat, group=mesh.get_group('data'))
    for t, f in zip(local, flat.split([t.numel() for t in local])):
        t.copy_(f.view_as(t))


def mean_over_data(tensors, mesh):
    """:func:`sum_over_data`, then divided by the number of ``data``
    ranks: the mean of the ranks' tensors, the same bits on every rank.
    With no mesh, nothing to do."""
    if mesh is None:
        return
    sum_over_data(tensors, mesh)
    n = data_size(mesh)
    for t in tensors:
        (t.to_local() if hasattr(t, 'to_local') else t).div_(n)
