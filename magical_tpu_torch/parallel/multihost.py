"""Multi-process orchestration over ``torch.distributed``.

The counterpart of ``magical_tpu/parallel/multihost.py``.  Every process
(a rank) runs the same program; envs shard along the global batch, each
rank stepping its own rows on its own device.  Envs never communicate, so
rollouts scale with the ranks; only the learner's gradient sums and the
aggregation of scores cross ranks (NCCL between cards, gloo on the CPU).

A rank's envs are bit for bit rows ``[start, start + local)`` of a
one-process reset of the global batch from the same seed: every draw of
a reset is made at the global batch's shape and the rank keeps its rows
(``tasks/randomize.RowSlice``).  This stands in for JAX's ``fold_in`` of
the env index, which torch's generators cannot reproduce.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None, timeout=None):
    """``torch.distributed.init_process_group`` for `num_processes` ranks
    meeting at `coordinator_address` (``host:port``, or a full
    ``tcp://`` address); a no-op for one process or when the group already
    exists.  The backend is NCCL when a CUDA card is present, else gloo.
    Without `num_processes` the launcher's environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) is read.
    `timeout` (seconds) bounds each collective's wait, torch's default
    where None.  Returns whether it created the group."""
    if dist.is_initialized():
        return False
    if num_processes is None:
        num_processes = int(os.environ.get('WORLD_SIZE', 1))
        process_id = int(os.environ.get('RANK', 0))
        init_method = 'env://'
    else:
        init_method = coordinator_address
        if init_method is not None and '://' not in init_method:
            init_method = f'tcp://{init_method}'
    if num_processes <= 1:
        return False
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    kw = {} if timeout is None else {'timeout': datetime.timedelta(
        seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_batch_spec(global_batch: int):
    """Split a global env batch across the ranks; returns
    (local_batch, local_start)."""
    nproc = process_count()
    assert global_batch % nproc == 0, (global_batch, nproc)
    local = global_batch // nproc
    return local, local * process_index()


def host_local_seeds(seed: int, global_batch: int):
    """This rank's share of a global reset from `seed`: (generator,
    local, start), for ``BatchedEnv.reset(generator, local,
    global_batch=global_batch, start=start)``.  The generator is seeded the
    same on every rank, so the global seed assignment is the same."""
    local, start = global_batch_spec(global_batch)
    return torch.Generator().manual_seed(int(seed)), local, start


def mean_across_hosts(x):
    """The mean of `x` (a number or a tensor, the same shape on every
    rank) over the ranks, by one ``all_reduce``; `x` itself when there is
    no group or it has one rank."""
    if process_count() == 1:
        return x
    t = torch.as_tensor(x, dtype=torch.float64)
    if dist.get_backend() == 'nccl':
        t = t.cuda()
    t = t.clone()
    dist.all_reduce(t)
    t /= dist.get_world_size()
    return t if isinstance(x, torch.Tensor) else t.cpu().numpy()
