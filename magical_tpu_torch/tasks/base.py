"""Task framework: variant flags and shared reset helpers.

The PyTorch counterpart of ``magical_tpu/tasks/base.py``.  A task is
*data*: a :class:`TaskDef` with static sizes plus batched functions
``reset_from_draws(draws, flags) -> EnvState`` and
``score(state) -> (B,) f32``; :class:`Stack` collects the geometry of the
entities a reset has placed, per env, as obstacles for the next placement.

Every reset takes its random numbers through :class:`Draws`, one named
draw at a time, and places each entity through :func:`place`, so that
:class:`GivenDraws` can hand it the numbers another sampler drew (the
tests feed the JAX package's) and the whole reset can be compared value
for value.  ``TaskDef.reset_fn`` runs it on a generator's draws.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch import geometry as G
from magical_tpu_torch import trace
from magical_tpu_torch.core.state import (EnvState, N_ROBOT_BODIES, f32,
                                          place_robot)
from magical_tpu_torch.tasks import place_kernel
from magical_tpu_torch.tasks import randomize as R

KSUB = G.KSUB
NV = G.NV


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
    reset_from_draws: Callable  # (draws, flags) -> EnvState
    score_fn: Callable  # (state) -> (B,) f32
    # Per-block-slot DEFAULT shape codes + which slots can ever be active
    # under the default count (see static_block_shapes).
    default_shapes: Optional[Tuple[int, ...]] = None
    default_active: Optional[Tuple[bool, ...]] = None

    def reset_fn(self, generator: Optional[torch.Generator], batch: int,
                 flags: Flags, device,
                 counters: Optional[trace.KernelCounters] = None):
        """Reset `batch` envs on the draws of `generator` (a CPU or CUDA
        generator, or a :class:`randomize.RowSlice` of one); the placement
        kernel counts into `counters` where given."""
        return self.reset_from_draws(
            Draws(generator, batch, device, counters), flags)

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

    def reachable_shape_types(self, flags: Flags):
        """Every shape-type code an env with these flags can instantiate:
        the default slots' codes, and RAND_SHAPE_TYPES (entities.py:568-574)
        when shape or count is randomised."""
        codes = set()
        if self.default_shapes is not None:
            act = self.default_active or (True,) * len(self.default_shapes)
            codes |= {int(s) for s, a in zip(self.default_shapes, act) if a}
        if flags.shape or flags.count:
            codes |= {int(s) for s in C.RAND_SHAPE_TYPES}
        return codes


# The variants of the task families that have all eight
# (registered in the reference's benchmarks/__init__.py).

FULL_VARIANTS = ('Demo', 'TestJitter', 'TestColour', 'TestShape',
                 'TestLayout', 'TestCountPlus', 'TestDynamics', 'TestAll')

FULL_VARIANT_FLAGS = {
    'Demo': Flags(),
    'TestJitter': Flags(layout_minor=True),
    'TestColour': Flags(colour=True),
    'TestShape': Flags(shape=True),
    'TestLayout': Flags(layout_full=True),
    'TestCountPlus': Flags(colour=True, shape=True, count=True,
                           layout_full=True),
    'TestDynamics': Flags(dynamics=True),
    'TestAll': Flags(colour=True, shape=True, count=True, layout_full=True,
                     dynamics=True),
}


class Draws:
    """The random numbers of one batched reset, drawn from a CPU or CUDA
    `generator` (or a :class:`randomize.RowSlice` of one) in call order.
    Every draw is per env, (B, *shape), and named; the names are what
    :class:`GivenDraws` looks up.  `counters`, where given, is what the
    reset's placement kernel counts into (:func:`place`)."""

    def __init__(self, generator: Optional[torch.Generator], batch: int,
                 device, counters: Optional[trace.KernelCounters] = None):
        self.generator = generator
        self.batch = batch
        self.device = torch.device(device)
        self.counters = counters

    def uniform(self, name: str, shape=()):
        """Uniforms in [0, 1), f32."""
        return R.draw(R.rand, self.device, self.generator,
                      (self.batch,) + tuple(shape))

    def randint(self, name: str, low: int, high, shape=()):
        """Integers in [low, high), i32; `high` is an int or a per-env
        (B,) tensor."""
        if isinstance(high, torch.Tensor):
            u = self.uniform(name, shape)
            span = (high - low).to(torch.float32).reshape(
                (-1,) + (1,) * len(shape))
            return (low + torch.floor(u * span)).to(torch.int32)
        return R.draw(R.randint, self.device, self.generator, low, high,
                      (self.batch,) + tuple(shape), dtype=torch.int32)

    def choice(self, name: str, values, shape=()):
        """rng.choice over a static tuple of integer codes: the draw is the
        index into `values`."""
        idx = self.randint(name, 0, len(values), shape)
        return torch.as_tensor(np.asarray(values, np.int32),
                               device=self.device)[idx.long()]


class GivenDraws(Draws):
    """Draws handed in: `values` maps each draw's name to its (B, *shape)
    array, the uniforms of a `uniform` and the integers of a `randint` (the
    index of a `choice`)."""

    def __init__(self, values: dict, batch: int, device):
        super().__init__(None, batch, device)
        self.values = values

    def _given(self, name, dtype, shape):
        x = torch.as_tensor(np.array(self.values[name]), dtype=dtype,
                            device=self.device)
        want = (self.batch,) + tuple(shape)
        if tuple(x.shape) != want:
            raise ValueError(f'draw {name!r} has shape {tuple(x.shape)}, '
                             f'the reset takes {want}')
        return x

    def uniform(self, name, shape=()):
        return self._given(name, torch.float32, shape)

    def randint(self, name, low, high, shape=()):
        return self._given(name, torch.int32, shape)


@functools.lru_cache(maxsize=None)
def device_constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """A constant tuple of a score function as a tensor on `device`, made
    once per device: a step copies nothing from the host for it."""
    return torch.tensor(np.asarray(values), dtype=dtype, device=device)


def per_env(x, batch: int, device, dtype=torch.float32):
    """A static table, the same for every env: (B, *x.shape)."""
    t = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return t.expand((batch,) + tuple(t.shape)).contiguous()


def phys_from_draws(d: Draws, flags: Flags):
    """PhysicsVariables.defaults() / .sample(), per env: (B, 5)."""
    if not flags.dynamics:
        return f32(C.PHYS_VAR_DEFAULTS, d.device).repeat(d.batch, 1)
    lo = f32(C.PHYS_VAR_LO, d.device)
    hi = f32(C.PHYS_VAR_HI, d.device)
    return lo + d.uniform('phys', (C.N_PHYS_VARS,)) * (hi - lo)


def place(d: Draws, name: str, geom, pos, angle, stack: 'Stack', mask=None,
          **kw):
    """Place one entity per env against the stack's rows (all of them, or
    those `mask` keeps), from the proposals of draw `name`:
    :func:`randomize.place_from_proposals` on ``name/pos`` (B, N_TRIES, 2)
    and ``name/ang`` (B, N_TRIES), its proposals tested by
    :func:`place_kernel.first_fit` (the kernel on the card, counting into
    the draws' counters; the plain test on the CPU), in one
    ``magical.reset.place`` span.  Returns (pos, angle, ok)."""
    with trace.span('magical.reset.place'):
        u_pos = d.uniform(f'{name}/pos', (R.N_TRIES, 2))
        u_ang = d.uniform(f'{name}/ang', (R.N_TRIES,))
        props_pos, props_ang = R.proposals(u_pos, u_ang, pos, angle, **kw)
        pick, ok = place_kernel.first_fit(
            props_pos, props_ang, geom, stack.placed(),
            stack.mask if mask is None else mask, counters=d.counters)
        return (*R.take(props_pos, props_ang, pick), ok)


# ---------------------------------------------------------------------------
# Placement stack: incrementally-placed entity world geometry
# ---------------------------------------------------------------------------

class Stack:
    """The placed entities' world geometry, per env, as obstacles for the
    next placement (the incremental collision re-enabling of
    pm_randomise_all_poses, geom.py:300-341).

    Rows are entity slots.  Only rows that were `put` are handed to the
    placement (a row never put is absent in every env), so their number,
    and the placement's work, grows with the reset."""

    def __init__(self, n_entities: int, batch: int, device):
        self._n = n_entities
        self._rows = {}            # slot -> (world geometry, present (B,))
        # running count of failed placements (reference: PlacementError,
        # geom.py:111-113); threaded into EnvState.place_fail by resets
        self.fails = torch.zeros((batch,), dtype=torch.int32, device=device)
        self._batch, self._device = batch, device

    def put(self, idx, geom_local, pos, angle, present=True, ok=True):
        """Place entity slot `idx` at (pos (B, 2), angle (B,)) in every env
        where `present`; count a failure where present and not `ok`."""
        if not 0 <= idx < self._n:
            raise IndexError(f'slot {idx} of a {self._n}-entity stack')
        present = torch.as_tensor(present, dtype=torch.bool,
                                  device=self._device).expand(self._batch)
        ok = torch.as_tensor(ok, dtype=torch.bool, device=self._device)
        self._rows[idx] = (R.transform_entity(geom_local, pos, angle),
                           present)
        self.fails = self.fails + (present & ~ok).to(torch.int32)

    def _order(self):
        return sorted(self._rows)

    def placed(self):
        """World geometry of the rows put so far, each field (B, E, ...)."""
        rows = [self._rows[i][0] for i in self._order()]
        if not rows:
            return tuple(torch.zeros((self._batch, 0) + shp, dtype=dt,
                                     device=self._device)
                         for shp, dt in (((KSUB, NV, 2), torch.float32),
                                         ((KSUB,), torch.float32),
                                         ((KSUB,), torch.int32),
                                         ((KSUB,), torch.bool)))
        return tuple(torch.stack([r[k] for r in rows], 1) for k in range(4))

    @property
    def mask(self):
        """(B, E) bool: which placed rows to collide against."""
        return self.mask_without()

    def mask_without(self, *hidden):
        """`mask` with the rows of the slots in `hidden` cleared."""
        cols = [self._rows[i][1] & (i not in hidden) for i in self._order()]
        if not cols:
            return torch.zeros((self._batch, 0), dtype=torch.bool,
                               device=self._device)
        return torch.stack(cols, 1)


def robot_geom(batch: int, device):
    """The robot's placement geometry, the same for every env."""
    return tuple(torch.as_tensor(x, device=device).expand(
        (batch,) + x.shape) for x in R.robot_placement_geom())


def jitter_limits(flags: Flags):
    """(pos_linf, rot) limits for minor-jitter placement."""
    if flags.layout_minor:
        return C.JITTER_POS_BOUND, C.JITTER_ROT_BOUND
    return None, None


def goal_center(xyhw):
    """Reference goal spec (x, y, h, w) with x,y = TOP-LEFT corner
    (entities.py:794-797) -> centre (cx, cy)."""
    x, y, h, w = xyhw
    return (x + w / 2.0, y - h / 2.0)


def com_in_goal(p, cxcyhw):
    """cpBB.contains_vect of the goal sensor box (entities.py:851-857)."""
    cx, cy, h, w = cxcyhw[..., 0], cxcyhw[..., 1], cxcyhw[..., 2], \
        cxcyhw[..., 3]
    return (torch.abs(p[..., 0] - cx) <= w / 2.0) & \
        (torch.abs(p[..., 1] - cy) <= h / 2.0)


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


def set_goals(state: EnvState, cxcyhw, colours, active):
    """Write the goal arrays, each per env, (B, MG[, 4])."""
    dev = state.device
    return state.replace(
        goal_xyhw=torch.as_tensor(cxcyhw, dtype=torch.float32, device=dev),
        goal_colour=torch.as_tensor(colours, dtype=torch.int32, device=dev),
        goal_active=torch.as_tensor(active, dtype=torch.bool, device=dev),
    )


def finalize_robot(state: EnvState, pos, angle):
    return place_robot(state, pos, angle)
