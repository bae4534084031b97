"""Rollout collection split over the data ranks.

The counterpart of ``magical_tpu/parallel/rollout.py``.  Envs are
embarrassingly parallel, so each rank of the mesh's ``data`` dim steps its
own rows of the global batch with no communication; only the end scores
are gathered, once, so that every rank holds the global (batch,) scores.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist

from magical_tpu_torch import constants as C
from magical_tpu_torch.api.batched_env import BatchedEnv
from magical_tpu_torch.parallel import mesh as M
from magical_tpu_torch.tasks import randomize


def random_policy(batch: int, global_batch: Optional[int] = None,
                  start: int = 0):
    """policy(obs, generator) -> int32 actions of `batch` envs: rows
    ``[start, start + batch)`` of a uniform draw of (global_batch,)
    actions a step, so that a rank's actions do not depend on the number
    of ranks."""
    gb = batch if global_batch is None else global_batch

    def policy(obs, generator):
        gen = randomize.RowSlice(generator, gb, start)
        return randomize.randint(gen, 0, C.N_ACTIONS, (batch,)).to(
            torch.int32)
    return policy


def _generators(generator_or_seed, device):
    """(reset generator, policy generator): a given generator serves both;
    a seed makes a CPU generator for the resets and one on `device` for
    the policy, both seeded with it."""
    if isinstance(generator_or_seed, torch.Generator):
        return generator_or_seed, generator_or_seed
    seed = int(generator_or_seed)
    return (torch.Generator().manual_seed(seed),
            torch.Generator(device=device).manual_seed(seed))


def rollout_episodes(env: BatchedEnv, policy_fn: Optional[Callable],
                     generator_or_seed: Union[torch.Generator, int],
                     batch_size: int, mesh=None,
                     length: Optional[int] = None) -> torch.Tensor:
    """Run `batch_size` whole episodes, this rank's rows of them on its
    device, and return their end-of-episode scores, (batch_size,) float32,
    gathered on every rank of the mesh's ``data`` dim.

    policy_fn(obs, generator) -> int32 actions of this rank's envs; None
    is the random policy (:func:`random_policy`).  The resets are this
    rank's rows of a one-process reset of `batch_size` envs (bit for bit),
    so with the random policy the scores do not depend on the number of
    ranks.  With no mesh, one process runs the whole batch."""
    length = length or env.max_episode_steps
    local, start = M.data_rows(mesh, batch_size)
    reset_gen, act_gen = _generators(generator_or_seed, env.device)
    if policy_fn is None:
        policy_fn = random_policy(local, batch_size, start)
    carry, obs = env.reset(reset_gen, local, global_batch=batch_size,
                           start=start)
    score = None
    for _ in range(length):
        act = policy_fn(obs, act_gen)
        carry, obs, _, _, info = env.step(carry, act)
        score = info['eval_score']
    if mesh is None or batch_size % mesh['data'].size():
        return score
    parts = [torch.empty_like(score) for _ in range(mesh['data'].size())]
    dist.all_gather(parts, score.contiguous(), group=mesh.get_group('data'))
    return torch.cat(parts)


def env_throughput(env: BatchedEnv, batch_size: int, n_steps: int = 30,
                   warmup: int = 3, seed: int = 0) -> float:
    """Steady-state env-steps/s of `env` at `batch_size` envs, no-op
    actions: `n_steps` steps after `warmup`, timed with CUDA events on the
    card (the host's clock on the CPU)."""
    carry, obs = env.reset(seed, batch_size)
    acts = torch.zeros((batch_size,), dtype=torch.int32, device=env.device)
    for _ in range(warmup):
        carry, obs, *_ = env.step(carry, acts)
    if env.device.type == 'cuda':
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n_steps):
            carry, obs, *_ = env.step(carry, acts)
        t1.record()
        t1.synchronize()
        dt = t0.elapsed_time(t1) / 1e3
    else:
        t = time.perf_counter()
        for _ in range(n_steps):
            carry, obs, *_ = env.step(carry, acts)
        dt = time.perf_counter() - t
    return batch_size * n_steps / dt
