"""A scene of the reference: one task family under one variant, observed
through one preprocessor at one fidelity, as a configuration file and a
traffic file name it.  Reset, one control step, fresh frames, the stacked
observation and the score, each in plain PyTorch over the frozen modules.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from portbench.reference import physics, preproc, randomize, render
from portbench.reference import dtype as DT
from portbench.reference.state import EnvState


class Scene:
    """`config` (a configuration file's dict) under `variant` at
    `fidelity` ('lo' or 'hi')."""

    def __init__(self, config: dict, variant: str, fidelity: str):
        module, attr = config['reference_task'].split(':')
        self.task = getattr(importlib.import_module(
            f'portbench.reference.{module}'), attr)
        self.flags = self.task.flags_for(variant)
        self.static_shapes = self.task.static_block_shapes(self.flags)
        self.robot_first = bool(config['robot_first'])
        self.spec = preproc.PREPROCESSORS[config['preproc']]
        if self.spec.raw or self.spec.stacked_dict:
            raise ValueError(f'preprocessor {config["preproc"]}: the '
                             f'reference stacks one observation array')
        self.fidelity = fidelity
        self.ep_len = self.task.ep_len

    def reset(self, generator: torch.Generator, batch: int, device):
        """The task's reset from `generator`, then each env's seed words,
        drawn from it in that order."""
        state = self.task.reset_fn(generator, batch, self.flags, device)
        seeds = randomize.randint(generator, 0, 2 ** 31 - 1, (batch, 2))
        return state.replace(rng=seeds.to(device))

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """One control step of every env."""
        return physics.control_step(state, action)

    def frames(self, state: EnvState) -> dict:
        """Fresh frames {view: (B, res, res, 3) uint8}."""
        return render.render_views(
            state, self.task.max_blocks, self.task.max_goals,
            self.robot_first, res=self.spec.res, views=self.spec.views,
            fidelity=self.fidelity, static_shapes=self.static_shapes)

    def observation(self, history: list) -> torch.Tensor:
        """The observation after the last of `history`, a list of
        :meth:`frames` dicts oldest first, one per step back to the reset
        (whose frame fills the stack before it)."""
        parts = []
        for view in self.spec.views:
            d = self.spec.depth(view)
            seen = [h[view] for h in history[-d:]]
            seen = [seen[0]] * (d - len(seen)) + seen
            parts.append(torch.cat(seen, -1))
        obs = torch.cat(parts, -1)
        if self.spec.channels_first:
            obs = obs.permute(0, 3, 1, 2).contiguous()
        return obs

    def score(self, state: EnvState) -> torch.Tensor:
        return self.task.score_fn(state)


def to_float(state: EnvState, dtype) -> EnvState:
    """`state` with every float field in `dtype` (the control's input)."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(dtype)
        for f in dataclasses.fields(state)
        if getattr(state, f.name).is_floating_point()})


__all__ = ['Scene', 'to_float', 'DT']
