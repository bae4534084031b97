"""GAIL: adversarial imitation with a PPO learner, on the card.

The counterpart of ``magical_tpu/train/gail.py``.  Rollouts come straight
from the batched env on its device: observations, actions, log-probs,
values and dones stay there, stacked (T, B, ...), and the discriminator's
reward, GAE and the PPO and discriminator updates run on them in place;
only minibatch indices are drawn on the host.  Both networks are Adam
(``optax.adam``'s defaults).  The discriminator is frozen while it wins
(accuracy above ``disc_freeze_acc``): its whole optimiser step is skipped,
parameters, both Adam moments and Adam's step count alike, which costs
one host read of the accuracy per update.

With a `mesh` (``parallel/mesh.py``) each rank collects its rows of the
global env batch and the gradients of both networks are summed over the
``data`` ranks, each rank's loss being its share of the global mean.  The
quantities of the whole rollout are global: the advantage is normalised
by the mean and std of every rank's advantages, and the discriminator's
freeze is decided on its accuracy over every rank's samples, so every rank
takes the same branch.  Minibatch and discriminator indices are drawn
over the global samples (the same draw on every rank) and each rank keeps
those of its rows; expert indices are split among the ranks in order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from magical_tpu_torch import constants as C
from magical_tpu_torch.api.batched_env import resolve_device
from magical_tpu_torch.models.nets import (Discriminator, MagicalCNN,
                                           obs_channels)
from magical_tpu_torch.parallel import mesh as M
from magical_tpu_torch.tasks import randomize
from magical_tpu_torch.train.bc import sample_actions

# rollout samples a discriminator forward takes at once in `collect`
# (bounds its activations' memory; the logits do not depend on it)
DISC_CHUNK = 4096


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


class GAILTrainer:
    """GAIL with a `MagicalCNN` policy (value head) and a `Discriminator`,
    both initialised as flax does from `seed`, on `env`'s device;
    data-parallel over `mesh` where one is given."""

    def __init__(self, env, obs_shape, num_actions: int = C.N_ACTIONS,
                 policy_lr: float = 3e-4, disc_lr: float = 1e-4,
                 gamma: float = 0.99, lam: float = 0.95,
                 clip_eps: float = 0.2, entropy_coef: float = 1e-3,
                 value_coef: float = 0.5, rollout_len: int = 40,
                 policy_widths: Optional[Sequence[int]] = None,
                 disc_widths: Optional[Sequence[int]] = None,
                 disc_freeze_acc: float = 0.9, disc_obs_only: bool = False,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: Union[str, torch.device, None] = None, mesh=None):
        self.env = env
        self.mesh = mesh
        self.device = env.device if device is None else resolve_device(device)
        self.obs_shape = tuple(obs_shape)
        gen = torch.Generator().manual_seed(seed)
        net_kw = {'widths': tuple(policy_widths)} if policy_widths else {}
        disc_kw = {'widths': tuple(disc_widths)} if disc_widths else {}
        ch = obs_channels(self.obs_shape)
        self.policy = MagicalCNN(num_actions, dtype=dtype,
                                 with_value_head=True, in_channels=ch,
                                 generator=gen, **net_kw).to(self.device)
        self.disc = Discriminator(num_actions, dtype=dtype, in_channels=ch,
                                  generator=gen, **disc_kw).to(self.device)
        split = M.model_split(mesh)
        if split:
            self.policy.split_fc(mesh)
        foreach = False if split else None
        self.policy_opt = torch.optim.Adam(self.policy.parameters(),
                                           lr=policy_lr, foreach=foreach)
        self.disc_opt = torch.optim.Adam(self.disc.parameters(), lr=disc_lr)
        self.gamma = gamma
        self.lam = lam
        self.clip_eps = clip_eps
        self.entropy_coef = entropy_coef
        self.value_coef = value_coef
        self.rollout_len = rollout_len
        self.disc_freeze_acc = disc_freeze_acc
        # obs-only discriminator (GAIfO): the reward comes only from
        # reaching expert-like observations
        self.disc_obs_only = disc_obs_only

    def _disc_act(self, act):
        return torch.zeros_like(act) if self.disc_obs_only else act

    # -- the data ranks -------------------------------------------------------

    def _local_samples(self, idx, T, B):
        """This rank's samples among global indices `idx` into the
        flattened (T, B·ranks) rollout, as indices into its own flattened
        (T, B) rollout (with no mesh, `idx` itself)."""
        idx = torch.as_tensor(idx, device=self.device).long()
        width = B * M.data_size(self.mesh)
        t, b = idx // width, idx % width - M.data_rank(self.mesh) * B
        keep = (b >= 0) & (b < B)
        return t[keep] * B + b[keep]

    def _sum_grads(self, module, extra):
        """Sum `module`'s gradients and the 1-d tensors `extra` over the
        data ranks (one all_reduce; nothing to do with no mesh)."""
        if self.mesh is None:
            return
        grads = []
        for p in module.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        M.sum_over_data(grads + list(extra), self.mesh)

    # -- rollout collection -------------------------------------------------

    @torch.no_grad()
    def collect(self, carry, obs, generator: torch.Generator):
        """`rollout_len` steps of the env from (carry, obs), actions drawn
        from the policy with `generator` (on the env's device).  Returns
        (carry, obs, traj): traj holds obs, act, logp, value, done and the
        AIRL reward (the discriminator's logit), each (T, B, ...), and the
        bootstrap value last_value (B,)."""
        T, B = self.rollout_len, obs.shape[0]
        dev = self.device
        traj = {'obs': torch.empty((T,) + tuple(obs.shape), dtype=obs.dtype,
                                   device=dev),
                'act': torch.empty((T, B), dtype=torch.int32, device=dev),
                'logp': torch.empty((T, B), device=dev),
                'value': torch.empty((T, B), device=dev),
                'done': torch.empty((T, B), dtype=torch.bool, device=dev)}
        for t in range(T):
            logits, value = self.policy(obs)
            act = sample_actions(logits, generator)
            logp = F.log_softmax(logits, -1)
            traj['obs'][t] = obs
            traj['act'][t] = act
            traj['logp'][t] = logp.gather(1, act.long()[:, None])[:, 0]
            traj['value'][t] = value
            carry, obs, _, done, _ = self.env.step(carry, act)
            traj['done'][t] = done
        # GAIL reward: the AIRL odds form log D - log(1 - D) = d_logit,
        # which keeps a unit gradient where the softplus form saturates
        flat_obs, flat_act = _flat(traj['obs']), self._disc_act(
            _flat(traj['act']))
        d_logit = torch.cat([
            self.disc(o, a) for o, a in zip(flat_obs.split(DISC_CHUNK),
                                            flat_act.split(DISC_CHUNK))])
        traj['reward'] = d_logit.reshape(T, B)
        traj['last_value'] = self.policy(obs)[1]
        return carry, obs, traj

    # -- GAE + PPO ----------------------------------------------------------

    @torch.no_grad()
    def gae(self, traj):
        """(advantages, returns), each (T, B): GAE(gamma, lam) over the
        rollout in reverse, bootstrapped from last_value, cut at dones."""
        rew, val, done = traj['reward'], traj['value'], traj['done']
        adv_next = torch.zeros_like(traj['last_value'])
        v_next = traj['last_value']
        advs = torch.empty_like(rew)
        for t in reversed(range(rew.shape[0])):
            nonterm = 1.0 - done[t].float()
            delta = rew[t] + self.gamma * v_next * nonterm - val[t]
            adv_next = delta + self.gamma * self.lam * nonterm * adv_next
            advs[t] = adv_next
            v_next = val[t]
        return advs, advs + val

    def ppo_update(self, traj, idx: Optional[torch.Tensor] = None):
        """One clipped-PPO Adam step on the rollout, or on its minibatch
        `idx` (indices into the flattened T*B samples; the advantage is
        normalised over the whole rollout first).  Returns {'pg',
        'vloss', 'entropy'}, 0-d tensors on the device."""
        advs, returns = self.gae(traj)
        T, B = advs.shape
        # the mean and population std (jnp.std's) of every rank's
        # advantages; each loss is this rank's share of the global mean
        n = T * B * M.data_size(self.mesh)
        tot = advs.sum()[None]
        M.sum_over_data([tot], self.mesh)
        advs = advs - tot / n
        sq = (advs * advs).sum()[None]
        M.sum_over_data([sq], self.mesh)
        advs = advs / (torch.sqrt(sq / n) + 1e-8)
        obs, act = _flat(traj['obs']), _flat(traj['act'])
        old_logp, adv, ret = (_flat(traj['logp']), _flat(advs),
                              _flat(returns))
        if idx is not None:
            n = len(idx)
            idx = self._local_samples(idx, T, B)
            obs, act, old_logp, adv, ret = (
                x.index_select(0, idx) for x in (obs, act, old_logp, adv,
                                                 ret))

        def mean(x):
            return x.sum() / n
        logits, value = self.policy(obs)
        logp_all = F.log_softmax(logits, -1)
        logp = logp_all.gather(1, act.long()[:, None])[:, 0]
        ratio = torch.exp(logp - old_logp)
        clipped = torch.clamp(ratio, 1 - self.clip_eps, 1 + self.clip_eps)
        pg = -mean(torch.minimum(ratio * adv, clipped * adv))
        vloss = mean((value - ret) ** 2)
        ent = -mean((torch.exp(logp_all) * logp_all).sum(-1))
        loss = pg + self.value_coef * vloss - self.entropy_coef * ent
        self.policy_opt.zero_grad(set_to_none=True)
        loss.backward()
        parts = torch.stack([pg.detach(), vloss.detach(), ent.detach()])
        self._sum_grads(self.policy, [parts])
        self.policy_opt.step()
        return dict(zip(('pg', 'vloss', 'entropy'), parts))

    # -- discriminator ------------------------------------------------------

    def disc_update(self, traj_obs, traj_act, idx_p, exp_obs, exp_act,
                    idx_e):
        """One Adam step of the discriminator on policy samples `idx_p` of
        the rollout (traj_obs/act (T, B, ...) as `collect` left them, or
        already flat) against expert samples `idx_e`, gathered on the
        device; skipped whole while its accuracy is above
        `disc_freeze_acc`.  Returns {'disc_loss', 'disc_acc'}."""
        dev = self.device
        n_p, n_e = len(idx_p), len(idx_e)
        if traj_obs.dim() == len(self.obs_shape) + 2:
            T, B = traj_obs.shape[:2]
            traj_obs, traj_act = _flat(traj_obs), _flat(traj_act)
            idx_p = self._local_samples(idx_p, T, B)
        elif self.mesh is not None:
            raise ValueError('with a mesh, disc_update takes the '
                             '(T, B, ...) rollout as collect left it')
        idx_p = torch.as_tensor(idx_p, device=dev)
        idx_e = torch.as_tensor(idx_e, device=dev).tensor_split(
            M.data_size(self.mesh))[M.data_rank(self.mesh)]
        pol_obs = traj_obs.index_select(0, idx_p)
        pol_act = traj_act.index_select(0, idx_p)
        exp_obs = torch.as_tensor(exp_obs, device=dev).index_select(0, idx_e)
        exp_act = torch.as_tensor(exp_act, device=dev).index_select(0, idx_e)
        pol_logit = self.disc(pol_obs, self._disc_act(pol_act))
        exp_logit = self.disc(exp_obs, self._disc_act(exp_act))
        # expert -> 1, policy -> 0: this rank's share of each global mean;
        # the accuracy's counts are summed over the ranks before the
        # freeze is decided
        loss = (F.binary_cross_entropy_with_logits(
                    exp_logit, torch.ones_like(exp_logit),
                    reduction='sum') / n_e
                + F.binary_cross_entropy_with_logits(
                    pol_logit, torch.zeros_like(pol_logit),
                    reduction='sum') / n_p)
        counts = torch.stack([(exp_logit > 0).float().sum(),
                              (pol_logit <= 0).float().sum(),
                              loss.detach()])
        M.sum_over_data([counts], self.mesh)
        acc = 0.5 * (counts[0] / n_e + counts[1] / n_p)
        # adversarial balance: while the discriminator already wins, skip
        # its whole optimiser step (zeroing the gradients would still move
        # it through Adam's first moment); acc compares in float32
        if not bool(acc > self.disc_freeze_acc):
            self.disc_opt.zero_grad(set_to_none=True)
            loss.backward()
            self._sum_grads(self.disc, [])
            self.disc_opt.step()
        return {'disc_loss': counts[2], 'disc_acc': acc}

    # -- outer loop ---------------------------------------------------------

    def train(self, seed, expert_obs, expert_acts, iterations=10,
              batch_envs=64, disc_batch=256, ppo_epochs=4, verbose=True):
        """The JAX package's outer loop: each iteration resets
        `batch_envs` fresh envs (with a mesh: this rank's rows of them),
        collects a rollout, takes `ppo_epochs` full-rollout PPO steps and
        one discriminator step.  Returns the last metrics."""
        reset_gen = torch.Generator().manual_seed(seed)
        act_gen = torch.Generator(device=self.device).manual_seed(seed)
        expert_obs = torch.as_tensor(expert_obs, device=self.device)
        expert_acts = torch.as_tensor(expert_acts, device=self.device)
        rng = np.random.default_rng(0)
        if batch_envs % M.data_size(self.mesh):
            raise ValueError(f'{batch_envs} envs do not split over '
                             f'{M.data_size(self.mesh)} data ranks')
        local, start = M.data_rows(self.mesh, batch_envs)
        if local != batch_envs:
            act_gen = randomize.RowSlice(act_gen, batch_envs, start)
        verbose = verbose and (self.mesh is None or torch.distributed
                               .get_rank() == 0)
        pm = dm = None
        for it in range(iterations):
            # fresh episodes every iteration: the batched env has no
            # auto-reset, so rollouts must not run past the episode's end
            carry, obs = self.env.reset(reset_gen, local,
                                        global_batch=batch_envs, start=start)
            carry, obs, traj = self.collect(carry, obs, act_gen)
            for _ in range(ppo_epochs):
                pm = self.ppo_update(traj)
            n_pol = self.rollout_len * batch_envs
            idx_p = rng.choice(n_pol, size=min(disc_batch, n_pol),
                               replace=False)
            idx_e = rng.choice(len(expert_acts),
                               size=min(disc_batch, len(expert_acts)),
                               replace=False)
            dm = self.disc_update(traj['obs'], traj['act'], idx_p,
                                  expert_obs, expert_acts, idx_e)
            if verbose:
                pg = 'n/a' if pm is None else f'{float(pm["pg"]):+.4f}'
                print(f'gail it {it}: pg {pg} '
                      f'disc_acc {float(dm["disc_acc"]):.3f}', flush=True)
        return {'ppo': pm, 'disc': dm}
