"""Behavioural cloning on demo trajectories.

The counterpart of ``magical_tpu/train/bc.py``: a `MagicalCNN` policy
trained by AdamW on the negative log-likelihood of the demonstrated
actions.  AdamW's decay is decoupled and falls on every parameter, biases
and GroupNorm included, as ``optax.adamw``'s default does.  The trainer
keeps its network and optimiser on one device (the card unless the caller
asks for the CPU); a step leaves its metrics on the device, so a loop of
steps waits on the host only where it logs.  Multi-GPU training is not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from magical_tpu_torch import constants as C
from magical_tpu_torch.api.batched_env import resolve_device
from magical_tpu_torch.models.nets import MagicalCNN, obs_channels
from magical_tpu_torch.parallel import mesh as M
from magical_tpu_torch.tasks import randomize


def sample_actions(logits: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Categorical draws from `logits` (B, A) by the Gumbel-max trick, as
    ``jax.random.categorical`` draws: int32 (B,), with no host sync.
    `generator` may be a ``randomize.RowSlice`` (a rank's rows of a global
    batch's draws)."""
    tiny = torch.finfo(torch.float32).tiny
    u = randomize.rand(generator, logits.shape, logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
    return (logits.float() + gumbel).argmax(-1).to(torch.int32)


def policy_of(net, greedy=False):
    """policy(obs, generator) -> int32 actions of a `MagicalCNN` (with or
    without its value head), for ``BatchedEnv.rollout``: the argmax, or a
    draw from `generator` (on the env's device)."""
    @torch.no_grad()
    def policy(obs, generator):
        out = net(obs)
        logits = out[0] if isinstance(out, tuple) else out
        if greedy:
            return logits.argmax(-1).to(torch.int32)
        return sample_actions(logits, generator)
    return policy


class BCTrainer:
    """BC of a `MagicalCNN` policy (``widths``, ``dtype``) on (obs, acts)
    batches, on `device`, data-parallel over `mesh` where one is given.
    The network is initialised as flax does, from `seed`."""

    def __init__(self, obs_shape, num_actions: int = C.N_ACTIONS,
                 lr: float = 3e-4, weight_decay: float = 1e-5,
                 widths: Sequence[int] = (64, 128, 128, 256),
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: Union[str, torch.device] = 'cuda', mesh=None):
        self.device = resolve_device(device)
        self.obs_shape = tuple(obs_shape)
        self.mesh = mesh
        self.net = MagicalCNN(
            num_actions, widths, dtype, in_channels=obs_channels(obs_shape),
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        split = M.model_split(mesh)
        if split:
            self.net.split_fc(mesh)
        self.opt = torch.optim.AdamW(self.net.parameters(), lr=lr,
                                     weight_decay=weight_decay, eps=1e-8,
                                     foreach=False if split else None)
        self.step = 0

    def _tensor(self, x, dtype):
        return torch.as_tensor(x, device=self.device).to(dtype)

    def train_step(self, obs, acts) -> Dict[str, torch.Tensor]:
        """One AdamW step on the batch (with a mesh: this rank's rows of
        the global batch); returns {'loss', 'acc'}, 0-d tensors on the
        device (with a mesh: over the global batch)."""
        obs = self._tensor(obs, torch.uint8)
        acts = self._tensor(acts, torch.int64)
        logits = self.net(obs)
        nll = -F.log_softmax(logits, -1).gather(1, acts[:, None])[:, 0]
        loss = nll.mean()
        acc = (logits.argmax(-1) == acts).float().mean()
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        loss, acc = loss.detach()[None], acc[None]
        M.mean_over_data([p.grad for p in self.net.parameters()]
                         + [loss, acc], self.mesh)
        self.opt.step()
        self.step += 1
        return {'loss': loss[0], 'acc': acc[0]}

    def fit(self, obs: np.ndarray, acts: np.ndarray, batch_size=256,
            epochs=1, rng=None, log_every=50):
        """Epochs of shuffled batches (the permutation drawn from numpy, as
        the JAX package draws it, the same on every rank; with a mesh each
        rank steps on its rows of each global batch); returns the last
        step's metrics."""
        rng = rng or np.random.default_rng(0)
        n = len(acts)
        metrics = None
        for _ in range(epochs):
            perm = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = M.shard_batch(perm[i:i + batch_size], self.mesh)
                metrics = self.train_step(obs[idx], acts[idx])
                if self.step % log_every == 0:
                    print(f'bc step {self.step}: '
                          f'loss {float(metrics["loss"]):.4f} '
                          f'acc {float(metrics["acc"]):.3f}', flush=True)
        return metrics

    def policy_fn(self, greedy=False):
        """policy(obs, generator) -> int32 actions (`policy_of`)."""
        return policy_of(self.net, greedy)


def demos_to_dataset(trajectories) -> Dict[str, np.ndarray]:
    """Flatten preprocessed MAGICALTrajectory list into (obs, acts) arrays
    (obs at time t predicts act at t, dropping the final obs)."""
    all_obs, all_acts = [], []
    for traj in trajectories:
        obs = np.asarray(traj.obs)
        acts = np.asarray(traj.acts)
        all_obs.append(obs[:len(acts)])
        all_acts.append(acts)
    return {'obs': np.concatenate(all_obs),
            'acts': np.concatenate(all_acts).astype(np.int32)}
