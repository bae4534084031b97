"""The batched environment API of the port.

The PyTorch counterpart of ``magical_tpu/api/batched_env.py``: an
environment family stepped for thousands of instances in lockstep.

    env = BatchedEnv('MoveToCorner-Demo-LoRes4E-v0')     # on the card
    carry, obs = env.reset(seed, 4096)
    carry, obs, rew, done, info = env.step(carry, actions)

On a CUDA device each step runs the control-step kernel
(``core/physics_kernel.py``), then the render kernel of the env's
fidelity (lo or hi, ``core/render_kernel.py``), which writes the new frame
into slot ``t mod depth`` of each view's frame ring, then assembles the
observation.  Raw IDs (no preprocessor suffix, and the DebugReward IDs)
observe a ``{allo, ego}`` dict of fresh 384² frames instead, with no ring.
With ``render_enabled=False`` a reset or a step runs no render kernel and
returns ``{}`` as the observation (physics and the score only).
The entry points run on the card unless asked for the CPU
(``device='cpu'``), where the same calls run the kernels' plain PyTorch
versions; without a card and without ``device='cpu'`` they raise.  `done`
fires exactly at the episode's max step and ``info['eval_score']``
carries the end-of-episode score, zero elsewhere.

The port serves every variant and preprocessor of all eight task families
at both fidelities.  The render kernels' 2-D tiled variant (K5,
``render_views_lo(tiles2d=...)``) is reached through its argument, as in
the JAX package; the step uses K2/K3 or K4.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch import trace
from magical_tpu_torch.api import spaces
from magical_tpu_torch.api.names import EnvName
from magical_tpu_torch.core import physics_kernel, preproc, render_kernel
from magical_tpu_torch.core.state import EnvState
from magical_tpu_torch.tasks import ALL_TASKS, randomize
from magical_tpu_torch.tasks.move_to_corner import debug_shaped_reward


# The kernels' counters of BatchedEnv.counters(), in the order the step
# passes them: K1's, then K4's.
COUNTERS = {'k1_cycles': physics_kernel.PHASES,
            'k1_items': physics_kernel.ITEMS,
            'k4_cycles': render_kernel.K4_PHASES,
            'k4_items': render_kernel.K4_ITEMS,
            'k4_pixels': render_kernel.K4_PIXELS}


@dataclasses.dataclass
class EnvCarry:
    """Full per-batch carried state: physics state, the frame rings
    ({view: (depth, B, res, res, 3) uint8}; empty for raw observations)
    and the lockstep step count (a host int equal to every env's
    ``state.t``)."""
    state: EnvState
    frames: dict
    t: int


def resolve_device(device) -> torch.device:
    """The torch device of an entry point's `device` argument.  The port
    runs on the card unless the caller asks for the CPU: a CUDA device
    (the default) without a card raises, with no fall-back to the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'magical_tpu_torch runs on a CUDA card by default and none is '
            "available: pass device='cpu' to run the plain PyTorch versions "
            'of the kernels on the CPU')
    return device


class BatchedEnv:
    """Batched environment family for one registered env ID, on one
    device: the CUDA card by default, the CPU with ``device='cpu'``."""

    def __init__(self, env_name: str, fidelity: str = 'lo',
                 render_enabled: bool = True,
                 device: Union[str, torch.device] = 'cuda'):
        # constructor arguments for pickling (EzPickle semantics, as in the
        # JAX package)
        self._ctor = dict(env_name=env_name, fidelity=fidelity,
                          render_enabled=render_enabled, device=device)
        name = EnvName(env_name)
        self.env_name = env_name
        self.device = resolve_device(device)
        if fidelity not in ('lo', 'hi'):
            raise ValueError(f'fidelity must be lo or hi, not {fidelity!r}')
        self.task = ALL_TASKS[name.task]
        # MoveToCorner-Demo-DebugReward[-<preproc>]-v0 IDs are registered
        # with the RAW entry point in the reference
        # (benchmarks/__init__.py:1021-1047), so the preproc suffix is
        # cosmetic there; as in the JAX package
        self.debug_reward = (name.variant == 'Demo'
                             and name.preproc is not None
                             and name.preproc.startswith('DebugReward'))
        self.preproc = preproc.get_preproc(
            None if self.debug_reward else name.preproc)
        self.flags = self.task.flags_for(name.variant)
        self.fidelity = fidelity
        # False: physics and the score only, with `{}` as the observation
        self.render_enabled = render_enabled
        self.max_episode_steps = self.task.ep_len
        # MoveToCorner adds the robot before its block (draw order)
        self.robot_first = (name.task == 'MoveToCorner')
        self.static_shapes = self.task.static_block_shapes(self.flags)
        # {batch: the int64 counters of K1, (batch, len(PHASES)) cycles a
        # phase and (batch, len(ITEMS)) its narrowphase's items, then of
        # K4, (batch, len(K4_PHASES)) cycles, (batch, len(K4_ITEMS)) prims
        # and (batch, len(K4_PIXELS)) pixels}, counted while a profiler
        # records (counters)
        self._counts = {}

    # -- rendering ---------------------------------------------------------

    def _render_args(self):
        return (self.task.max_blocks, self.task.max_goals, self.robot_first)

    def render_views(self, state: EnvState, res: int, views) -> dict:
        """Fresh frames {view: (B, res, res, 3) uint8} of `state` at the
        env's fidelity: through K4 (hi) or K3 (lo) on CUDA, their plain
        versions on the CPU."""
        fresh = (render_kernel.render_views_hi if self.fidelity == 'hi'
                 else render_kernel.render_views_lo)
        return fresh(state, *self._render_args(), res=res, views=views,
                     static_shapes=self.static_shapes)

    def _render_fresh(self, state: EnvState) -> dict:
        return self.render_views(state, self.preproc.res, self.preproc.views)

    def _render_into_rings(self, state: EnvState, frames: dict, t: int,
                           k4_counts=(None,) * 3):
        args = (state, frames, t, *self._render_args(), self.preproc)
        kwargs = dict(res=self.preproc.res, static_shapes=self.static_shapes)
        if self.fidelity == 'hi':
            return render_kernel.render_hi_into_slots(
                *args, **kwargs, phase_clock=k4_counts[0],
                item_count=k4_counts[1], pixel_count=k4_counts[2])
        return render_kernel.render_into_slots(*args, **kwargs)

    # -- the API -----------------------------------------------------------

    def reset(self, generator_or_seed: Union[torch.Generator, int],
              batch: int, global_batch: Optional[int] = None,
              start: int = 0):
        """Reset `batch` envs; returns (carry, obs).  Randomness comes
        from the given CPU generator (or one seeded with the int).  With
        `global_batch`, the envs are rows ``[start, start + batch)`` of a
        reset of `global_batch` envs from the same generator, bit for bit
        (a data-parallel rank's share, ``parallel/multihost.py``)."""
        with trace.span('magical.reset'):
            trace.count('resets')
            return self._reset(generator_or_seed, batch, global_batch, start)

    def _reset(self, gen, batch, global_batch, start):
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator().manual_seed(int(gen))
        if global_batch is not None and (global_batch, start) != (batch, 0):
            gen = randomize.RowSlice(gen, global_batch, start)
        state = self.task.reset_fn(gen, batch, self.flags, self.device)
        seeds = randomize.draw(randomize.randint, self.device, gen, 0,
                               2 ** 31 - 1, (batch, 2))
        state = state.replace(rng=seeds)
        if not self.render_enabled:
            return EnvCarry(state=state, frames={}, t=0), {}
        with trace.span('magical.reset.render'):
            raw = self._render_fresh(state)
        if self.preproc.raw:
            return EnvCarry(state=state, frames={}, t=0), raw
        with trace.span('magical.reset.frames'):
            frames = preproc.init_frames_cf(self.preproc, raw)
            obs = preproc.observation_cf(self.preproc, frames, 0,
                                         self.preproc.res)
        return EnvCarry(state=state, frames=frames, t=0), obs

    def step(self, carry: EnvCarry, action):
        """One control step of every env: (carry, obs, reward, done,
        info).  On CUDA the physics kernel updates ``carry.state`` in place
        and the frame rings are written in place.  While a profiler
        records, the physics kernel counts its cycles a phase and its
        narrowphase's items into :meth:`counters`' ``k1_cycles`` and
        ``k1_items``, and at hi K4 its cycles a phase, its prims and its
        pixels into ``k4_cycles``, ``k4_items`` and ``k4_pixels``."""
        with trace.span('magical.step'):
            trace.count('steps')
            return self._step(carry, action)

    def _step(self, carry: EnvCarry, action):
        action = torch.as_tensor(action, device=self.device).to(torch.int32)
        B = action.shape[0]
        counts = (None,) * len(COUNTERS)
        if self.device.type == 'cuda' and trace.recording():
            if B not in self._counts:
                self._counts[B] = tuple(
                    torch.zeros((B, len(n)), dtype=torch.int64,
                                device=self.device)
                    for n in COUNTERS.values())
            counts = self._counts[B]
        state = physics_kernel.control_step(carry.state, action.contiguous(),
                                            phase_clock=counts[0],
                                            item_count=counts[1])
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
        if not self.render_enabled:
            frames, obs = {}, {}
        elif self.preproc.raw:
            frames = {}
            with trace.span('magical.render'):
                obs = self._render_fresh(state)
        else:
            frames = self._render_into_rings(state, carry.frames, t,
                                             counts[2:])
            obs = preproc.observation_cf(self.preproc, frames, t,
                                         self.preproc.res)
        with trace.span('magical.score'):
            done = state.t >= self.max_episode_steps
            score = torch.where(done, self.task.score_fn(state), 0.0)
        if self.debug_reward:
            reward = debug_shaped_reward(state)
        else:
            reward = torch.zeros((B,), dtype=torch.float32,
                                 device=self.device)
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

    def counters(self) -> dict:
        """The counts of :mod:`magical_tpu_torch.trace`, made while a
        ``torch.profiler`` recorded (``resets``, ``steps``,
        ``reset_syncs``, ``reset_draw_bytes``, over every env of the
        process), and, over this env's recorded steps on the card, K1's
        cycles in each phase of ``physics_kernel.PHASES`` (``k1_cycles``)
        and its narrowphase's items of ``physics_kernel.ITEMS``
        (``k1_items``: the items of active slots, and those tested in
        full, summed over substeps), and K4's cycles in each phase of
        ``render_kernel.K4_PHASES`` (``k4_cycles``) and its prims of
        ``render_kernel.K4_ITEMS`` (``k4_items``: the active prims from
        slot 2 up, and those the tile cull kept, summed over blocks) and
        its pixels of ``render_kernel.K4_PIXELS`` (``k4_pixels``: the
        frames' pixels, and those shaded per subpixel because a prim's edge
        crosses them; K4's zero at lo): read from the card, so it syncs;
        call it after a run."""
        sums = [[0] * len(n) for n in COUNTERS.values()]
        for counts in self._counts.values():
            sums = [[a + b for a, b in zip(s, c.sum(0).tolist())]
                    for s, c in zip(sums, counts)]
        return dict(trace.counts(), **{
            key: dict(zip(names, total))
            for (key, names), total in zip(COUNTERS.items(), sums)})

    # -- pickling (reference envs are EzPickle-able) ------------------------

    def __getstate__(self):
        return dict(self._ctor)

    def __setstate__(self, ctor):
        self.__init__(**ctor)

    @property
    def action_space(self):
        return spaces.Discrete(C.N_ACTIONS)

    @property
    def observation_space(self):
        sp = self.preproc
        if sp.raw or sp.stacked_dict:
            depth = 3 if sp.raw else 12
            box = spaces.Box(0, 255, (sp.res, sp.res, depth), np.uint8)
            return spaces.Dict(collections.OrderedDict(
                [('allo', box), ('ego', box)]))
        depth = (sp.allo_frames + sp.ego_frames) * 3
        shape = (depth, sp.res, sp.res) if sp.channels_first \
            else (sp.res, sp.res, depth)
        return spaces.Box(0, 255, shape, np.uint8)
