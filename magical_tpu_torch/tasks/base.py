"""Task framework: variant flags and shared reset helpers.

The PyTorch counterpart of the parts of ``magical_tpu/tasks/base.py``
that MoveToCorner's fixed-layout variants need.  A task is *data*: a
:class:`TaskDef` with static sizes plus batched functions
``reset(generator, batch, flags, device) -> EnvState`` and
``score(state) -> (B,) f32``.  The placement stack and layout
randomisation (``Stack``, ``tasks/randomize.py``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch.core.state import (EnvState, N_ROBOT_BODIES, f32,
                                          place_robot)


@dataclasses.dataclass(frozen=True)
class Flags:
    """Unified variant-randomisation flags."""
    colour: bool = False
    shape: bool = False
    count: bool = False
    layout_minor: bool = False
    layout_full: bool = False
    dynamics: bool = False

    @property
    def any_layout(self):
        return self.layout_minor or self.layout_full

    @property
    def any_random(self):
        return any(dataclasses.astuple(self))


@dataclasses.dataclass(frozen=True)
class TaskDef:
    name: str
    max_blocks: int
    max_goals: int
    ep_len: int
    variants: Tuple[str, ...]
    variant_flags: Dict[str, Flags]
    reset_fn: Callable  # (generator, batch, flags, device) -> EnvState
    score_fn: Callable  # (state) -> (B,) f32
    # Per-block-slot DEFAULT shape codes + which slots can ever be active
    # under the default count (see static_block_shapes).
    default_shapes: Optional[Tuple[int, ...]] = None
    default_active: Optional[Tuple[bool, ...]] = None

    def flags_for(self, variant: str) -> Flags:
        return self.variant_flags[variant]

    def static_block_shapes(self, flags: Flags):
        """Static per-slot shape table for this variant, or None: a shape
        code per block slot (None for a slot that is never active), when
        the variant randomises neither shape nor count."""
        if flags.shape or flags.count or self.default_shapes is None:
            return None
        act = self.default_active or (True,) * len(self.default_shapes)
        table = [int(s) if a else None
                 for s, a in zip(self.default_shapes, act)]
        table += [None] * (self.max_blocks - len(table))
        return tuple(table)


def sample_phys(generator: torch.Generator, batch: int, flags: Flags,
                device):
    """PhysicsVariables.defaults() / .sample(), per env: (B, 5)."""
    lo = f32(C.PHYS_VAR_LO, device)
    hi = f32(C.PHYS_VAR_HI, device)
    if not flags.dynamics:
        return f32(C.PHYS_VAR_DEFAULTS, device).repeat(batch, 1)
    u = torch.rand((batch, C.N_PHYS_VARS), generator=generator,
                   device=generator.device).to(device)
    return lo + u * (hi - lo)


def choice(generator: torch.Generator, values, batch: int, device):
    """rng.choice over a static tuple of integer codes, per env: (B,)."""
    idx = torch.randint(0, len(values), (batch,), generator=generator,
                        device=generator.device).to(device)
    return torch.as_tensor(np.asarray(values, np.int32), device=device)[idx]


def set_blocks(state: EnvState, shapes, colours, poses, angles, active):
    """Write block arrays + body poses for all block slots at once; each
    argument is per env, (B, MB[, 2])."""
    nb = N_ROBOT_BODIES
    mb = state.max_blocks
    dev = state.device
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    angles = torch.as_tensor(angles, dtype=torch.float32, device=dev)
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    # park inactive blocks far away
    park = torch.stack([50.0 + 4.0 * torch.arange(mb, dtype=torch.float32,
                                                  device=dev),
                        torch.full((mb,), 50.0, device=dev)], -1)
    pos = torch.where(active[..., None], poses, park)
    ang = torch.where(active, angles, 0.0)
    new_pos = state.pos.clone()
    new_angle = state.angle.clone()
    new_pos[:, nb:] = pos
    new_angle[:, nb:] = ang
    return state.replace(
        pos=new_pos, angle=new_angle,
        block_shape=torch.as_tensor(shapes, dtype=torch.int32, device=dev),
        block_colour=torch.as_tensor(colours, dtype=torch.int32, device=dev),
        block_active=active,
    )


def finalize_robot(state: EnvState, pos, angle):
    return place_robot(state, pos, angle)
