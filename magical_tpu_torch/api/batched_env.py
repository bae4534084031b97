"""The batched environment API of the port.

The PyTorch counterpart of ``magical_tpu/api/batched_env.py``: an
environment family stepped for thousands of instances in lockstep.

    env = BatchedEnv('MoveToCorner-Demo-LoRes4E-v0', device='cuda')
    carry, obs = env.reset(seed, 4096)
    carry, obs, rew, done, info = env.step(carry, actions)

On a CUDA device each step runs the control-step kernel
(``core/physics_kernel.py``), then the lo render kernel, which writes the
new frame into slot ``t mod depth`` of each view's frame ring
(``core/render_kernel.py``), then assembles the observation.  On the CPU
the same calls run the kernels' plain PyTorch versions.  `done` fires
exactly at the episode's max step and ``info['eval_score']`` carries the
end-of-episode score, zero elsewhere.

The port serves the Demo variant of MoveToCorner with the five LoRes
preprocessors at lo fidelity (hi fidelity on the CPU only); everything
else raises NotImplementedError naming the ROADMAP.md item that brings
it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import torch

from magical_tpu_torch.api.names import EnvName
from magical_tpu_torch.core import (physics_kernel, preproc, render,
                                    render_kernel)
from magical_tpu_torch.core.state import EnvState
from magical_tpu_torch.tasks import ALL_TASKS

_TODO = 'ROADMAP.md, "Modules to port", item {}'


@dataclasses.dataclass
class EnvCarry:
    """Full per-batch carried state: physics state, the frame rings
    ({view: (depth, B, res, res, 3) uint8}) and the lockstep step count
    (a host int equal to every env's ``state.t``)."""
    state: EnvState
    frames: dict
    t: int


class BatchedEnv:
    """Batched environment family for one registered env ID, on one
    device."""

    def __init__(self, env_name: str, fidelity: str = 'lo',
                 device: Union[str, torch.device] = 'cpu'):
        name = EnvName(env_name)
        self.env_name = env_name
        self.device = torch.device(device)
        if name.task not in ALL_TASKS:
            raise NotImplementedError(
                f'{env_name}: task {name.task} is not ported yet '
                f'({_TODO.format(2)})')
        if name.variant != 'Demo':
            raise NotImplementedError(
                f'{env_name}: variant {name.variant} is not ported yet; '
                f'randomised variants need tasks/randomize.py '
                f'({_TODO.format(1)})')
        if name.preproc is None or name.preproc.startswith('DebugReward'):
            raise NotImplementedError(
                f'{env_name}: raw and DebugReward observations are not '
                f'ported yet ({_TODO.format(4)})')
        if fidelity not in ('lo', 'hi'):
            raise ValueError(f'fidelity must be lo or hi, not {fidelity!r}')
        if fidelity == 'hi' and self.device.type == 'cuda':
            raise NotImplementedError(
                f'{env_name}: hi fidelity on CUDA needs the hi render '
                f'kernel ({_TODO.format(3)})')
        self.task = ALL_TASKS[name.task]
        self.preproc = preproc.get_preproc(name.preproc)
        self.flags = self.task.flags_for(name.variant)
        self.fidelity = fidelity
        self.max_episode_steps = self.task.ep_len
        # MoveToCorner adds the robot before its block (draw order)
        self.robot_first = (name.task == 'MoveToCorner')
        self.static_shapes = self.task.static_block_shapes(self.flags)

    # -- rendering ---------------------------------------------------------

    def _render_args(self):
        return (self.task.max_blocks, self.task.max_goals, self.robot_first)

    def _render_fresh(self, state: EnvState) -> dict:
        if self.fidelity == 'hi':
            return render.render_views(
                state, *self._render_args(), res=self.preproc.res,
                views=self.preproc.views, fidelity='hi',
                static_shapes=self.static_shapes)
        return render_kernel.render_views_lo(
            state, *self._render_args(), res=self.preproc.res,
            views=self.preproc.views, static_shapes=self.static_shapes)

    def _render_into_rings(self, state: EnvState, frames: dict, t: int):
        if self.fidelity == 'hi':
            return preproc.push_frames_cf(self.preproc, frames,
                                          self._render_fresh(state), t)
        return render_kernel.render_into_slots(
            state, frames, t, *self._render_args(), self.preproc,
            res=self.preproc.res, static_shapes=self.static_shapes)

    # -- the API -----------------------------------------------------------

    def reset(self, generator_or_seed: Union[torch.Generator, int],
              batch: int):
        """Reset `batch` envs; returns (carry, obs).  Randomness comes
        from the given CPU generator (or one seeded with the int)."""
        gen = generator_or_seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator().manual_seed(int(gen))
        state = self.task.reset_fn(gen, batch, self.flags, self.device)
        seeds = torch.randint(0, 2 ** 31 - 1, (batch, 2), generator=gen,
                              device=gen.device)
        state = state.replace(rng=seeds.to(self.device))
        raw = self._render_fresh(state)
        frames = preproc.init_frames_cf(self.preproc, raw)
        obs = preproc.observation_cf(self.preproc, frames, 0,
                                     self.preproc.res)
        return EnvCarry(state=state, frames=frames, t=0), obs

    def step(self, carry: EnvCarry, action):
        """One control step of every env: (carry, obs, reward, done,
        info).  On CUDA the physics kernel updates ``carry.state`` in place
        and the frame rings are written in place."""
        action = torch.as_tensor(action, device=self.device).to(torch.int32)
        B = action.shape[0]
        state = physics_kernel.control_step(carry.state, action.contiguous())
        t = carry.t + 1
        # LOCKSTEP INVARIANT: every env in the batch shares one step count
        # (fixed-length episodes, whole-batch resets), so the frame-ring
        # phase is the host's `t`.  MAGICAL_TPU_DEBUG_LOCKSTEP=1 checks it
        # against the device counters (one device sync per step).
        if os.environ.get('MAGICAL_TPU_DEBUG_LOCKSTEP'):
            tmin, tmax = int(state.t.min()), int(state.t.max())
            if not tmin == tmax == t:
                raise AssertionError(
                    f'BatchedEnv lockstep violated: t in [{tmin}, {tmax}], '
                    f'host step {t} — the frame-ring phase would be wrong '
                    f'for the whole batch')
        frames = self._render_into_rings(state, carry.frames, t)
        obs = preproc.observation_cf(self.preproc, frames, t,
                                     self.preproc.res)
        done = state.t >= self.max_episode_steps
        score = torch.where(done, self.task.score_fn(state), 0.0)
        reward = torch.zeros((B,), dtype=torch.float32, device=self.device)
        info = {'eval_score': score,
                'n_placement_failures': state.place_fail}
        return EnvCarry(state=state, frames=frames, t=t), obs, reward, \
            done, info

    def rollout(self, carry: EnvCarry, obs, policy_fn,
                generator: torch.Generator, length: Optional[int] = None):
        """Run `length` steps (default: a whole episode) from (carry, obs)
        as returned by reset: policy_fn(obs, generator) -> actions.
        Returns (carry, obs, rewards, dones, scores), the last three
        stacked over steps, (length, B)."""
        length = length or self.max_episode_steps
        rews, dones, scores = [], [], []
        for _ in range(length):
            act = policy_fn(obs, generator)
            carry, obs, rew, done, info = self.step(carry, act)
            rews.append(rew)
            dones.append(done)
            scores.append(info['eval_score'])
        return (carry, obs, torch.stack(rews), torch.stack(dones),
                torch.stack(scores))
