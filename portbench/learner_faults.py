"""Faults planted underneath the learner cell's harness, in the port's
``GAILTrainer`` or its ``BatchedEnv``, for the check's calibration on the card
(``calibrate_learner.py --fault``) and its CPU test: each must come out
not correct.  No benchmark run plants one.  (The cell runs on one card,
with no exchange between cards to leave out.)"""

from __future__ import annotations

import contextlib
import math

import torch


def _clip_dropped(ppo_update):
    def broken(self, traj, idx=None):
        old, self.clip_eps = self.clip_eps, math.inf
        try:
            return ppo_update(self, traj, idx)
        finally:
            self.clip_eps = old
    return broken


def _gae_not_cut(gae):
    def broken(self, traj):
        return gae(self, dict(traj, done=torch.zeros_like(traj['done'])))
    return broken


def _half_batch(ppo_update):
    def broken(self, traj, idx=None):
        return ppo_update(self, traj, idx[:len(idx) // 2])
    return broken


def _unchanged(ppo_update):
    def broken(self, traj, idx=None):
        opt = self.policy_opt
        opt.step = lambda *a, **k: None
        try:
            return ppo_update(self, traj, idx)
        finally:
            del opt.step
    return broken


def _disc_unchanged(disc_update):
    def broken(self, *args):
        opt = self.disc_opt
        opt.step = lambda *a, **k: None
        try:
            return disc_update(self, *args)
        finally:
            del opt.step
    return broken


def _disc_skipped_later(disc_update):
    def broken(self, *args):
        self._fault_disc_calls = getattr(self, '_fault_disc_calls', 0) + 1
        if self._fault_disc_calls == 1:
            return disc_update(self, *args)
        return _disc_unchanged(disc_update)(self, *args)
    return broken


def _reset_skipped_later(step, reset):
    """Every reset of a batch after its first hands back the carry and
    observation of that batch's last step: the episodes go on."""
    def stepped(self, carry, action):
        out = step(self, carry, action)
        last = self.__dict__.setdefault('_fault_last', {})
        last[out[1].shape[0]] = (out[0], out[1])
        return out

    def broken(self, generator, batch, *args, **kwargs):
        last = self.__dict__.get('_fault_last', {}).get(batch)
        if last is not None:
            return last
        return reset(self, generator, batch, *args, **kwargs)
    return {'step': stepped, 'reset': broken}


def _reward_altered(collect):
    def broken(self, carry, obs, generator):
        carry, obs, traj = collect(self, carry, obs, generator)
        traj['reward'][0, 0] += 0.5
        return carry, obs, traj
    return broken


FAULTS = {
    'the PPO clip dropped': ('ppo_update', _clip_dropped),
    'GAE not cut at episode ends': ('gae', _gae_not_cut),
    'half of each minibatch left out, the mean over the rest':
        ('ppo_update', _half_batch),
    'a PPO step that leaves the policy unchanged':
        ('ppo_update', _unchanged),
    'a reward altered where it is produced': ('collect', _reward_altered),
    'a discriminator step that leaves it unchanged':
        ('disc_update', _disc_unchanged),
    'the discriminator step skipped after the first iteration':
        ('disc_update', _disc_skipped_later),
    'the reset skipped after the first iteration':
        (('step', 'reset'), _reset_skipped_later),
}


@contextlib.contextmanager
def planted(fault: str):
    """``GAILTrainer`` (or, for the reset, ``BatchedEnv``) with `fault`
    planted while the block runs."""
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.train.gail import GAILTrainer
    name, make = FAULTS[fault]
    if isinstance(name, tuple):
        owner = BatchedEnv
        new = make(*(getattr(owner, n) for n in name))
    else:
        owner = GAILTrainer
        new = {name: make(getattr(owner, name))}
    old = {n: getattr(owner, n) for n in new}
    for n, f in new.items():
        setattr(owner, n, f)
    try:
        yield
    finally:
        for n, f in old.items():
            setattr(owner, n, f)
