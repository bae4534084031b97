"""The benchmark's frozen copy of ``magical_tpu_torch/core/state.py``,
part of the plain reference that decides a run's `correct`.  It
imports nothing of the port, so that no later change to the port
moves the yardstick; its float type is ``dtype.F``.

Canonical structure-of-arrays environment state, batched.

The PyTorch counterpart of ``magical_tpu/core/state.py``.  Where the JAX
package describes ONE env and batches it with ``vmap``, every field here
carries the env axis first: ``pos`` is (B, NB, 2), ``t`` is (B,).

Body slot convention (per env, ``NB = 5 + max_blocks``):

  0            robot main body   (dynamic circle)
  1, 2         finger bodies L/R (dynamic two-box polys)
  3, 4         eye bodies L/R    (dynamic, no collision shapes)
  5 .. 5+MB-1  pushable blocks

The kinematic control body is implicit: it has infinite mass, so the
control joints only ever see its velocity/angle targets, which are
derived from the action each substep.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import dtype as DT

from portbench.reference import constants as C
from portbench.reference import geometry as G

# fixed robot body count (main + 2 fingers + 2 eyes)
N_ROBOT_BODIES = 5
# parking position for inactive block bodies — far outside the arena so
# they can never generate contacts or affect scores.
PARK_POS = 50.0


def max_contacts(max_blocks: int) -> int:
    """Dense contact budget after compaction."""
    return 32 + 16 * max_blocks


def n_joint_acc(max_blocks: int) -> int:
    """Flattened joint-impulse accumulator length: robot pivot (2) + gear
    (1) + pin L/R (2) + rotary limit L/R (2) + finger motor L/R (2), then
    per block pivot (2 each) + gear (1 each).  Persisted across substeps
    and control steps like Chipmunk's cpConstraint jAcc warm start."""
    return 9 + 3 * max_blocks


@dataclasses.dataclass
class EnvState:
    """State of a batch of B environments (env axis first)."""
    # --- rigid body state -------------------------------------------------
    pos: torch.Tensor         # (B, NB, 2) f32
    angle: torch.Tensor       # (B, NB)  f32
    vel: torch.Tensor         # (B, NB, 2) f32
    omega: torch.Tensor       # (B, NB)  f32
    # Chipmunk-style pseudo velocities: accumulated by the contact solver,
    # applied to positions at the next substep, then cleared.
    v_bias: torch.Tensor      # (B, NB, 2) f32
    w_bias: torch.Tensor      # (B, NB)  f32

    # --- robot control targets (set once per control step) ---------------
    target_speed: torch.Tensor         # (B,) f32
    rel_turn_angle: torch.Tensor       # (B,) f32
    target_finger_angle: torch.Tensor  # (B,) f32

    # --- per-block semantic state ----------------------------------------
    block_shape: torch.Tensor   # (B, MB) i32 ShapeType codes
    block_colour: torch.Tensor  # (B, MB) i32 ShapeColour codes
    block_active: torch.Tensor  # (B, MB) bool

    # --- goal regions ------------------------------------------------------
    goal_xyhw: torch.Tensor     # (B, MG, 4) f32 — x, y = TOP-LEFT corner
    goal_colour: torch.Tensor   # (B, MG) i32
    goal_active: torch.Tensor   # (B, MG) bool

    # --- warm-start caches (Chipmunk arbiter/constraint jAcc) -------------
    # Carried across substeps AND control steps.
    con_id: torch.Tensor        # (B, MAXC) i32 candidate id, -1 = empty
    con_jn: torch.Tensor        # (B, MAXC) f32 accumulated normal impulse
    con_jt: torch.Tensor        # (B, MAXC) f32 accumulated friction impulse
    joint_acc: torch.Tensor     # (B, n_joint_acc(MB)) f32

    # --- misc -------------------------------------------------------------
    aux: torch.Tensor           # (B, 4) i32 task-specific extras
    place_fail: torch.Tensor    # (B,) i32 failed reset placements
    phys: torch.Tensor          # (B, 5) f32 PhysicsVariables vector
    rng: torch.Tensor           # (B, 2) i64 per-env seed words
    t: torch.Tensor             # (B,) i32 episode step counter

    def replace(self, **changes) -> 'EnvState':
        return dataclasses.replace(self, **changes)

    def clone(self) -> 'EnvState':
        return EnvState(**{f.name: getattr(self, f.name).clone()
                           for f in dataclasses.fields(self)})

    @property
    def batch(self):
        return self.pos.shape[0]

    @property
    def device(self):
        return self.pos.device

    @property
    def n_bodies(self):
        return self.pos.shape[-2]

    @property
    def max_blocks(self):
        return self.block_shape.shape[-1]

    @property
    def robot_pos(self):
        return self.pos[..., 0, :]

    @property
    def robot_angle(self):
        return self.angle[..., 0]

    @property
    def block_pos(self):
        return self.pos[..., N_ROBOT_BODIES:, :]

    @property
    def block_angle(self):
        return self.angle[..., N_ROBOT_BODIES:]


def f32(x, device) -> torch.Tensor:
    """A tensor of the reference's float type (float32 but in the control,
    ``dtype.lowered``) of a numpy table on `device`, rounded to float32
    first: several geometry tables are float64 before their final cast."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device).to(DT.F)


def inv_mass_arrays(state: EnvState):
    """Per-body inverse mass / inverse moment, (B, NB) each.

    Block moments depend on the per-env shape type; inactive blocks get
    zero inverse mass so they behave as static parked bodies."""
    dev = state.device
    inv_m_robot = np.array([
        1.0 / C.ROBOT_MASS,
        1.0 / C.FINGER_MASS, 1.0 / C.FINGER_MASS,
        1.0 / C.EYE_MASS, 1.0 / C.EYE_MASS], dtype=np.float32)
    inv_i_robot = np.array([
        1.0 / G.ROBOT_GEOM['body_moment'],
        1.0 / G.ROBOT_GEOM['finger_moment'],
        1.0 / G.ROBOT_GEOM['finger_moment'],
        1.0 / G.ROBOT_GEOM['eye_moment'],
        1.0 / G.ROBOT_GEOM['eye_moment']], dtype=np.float32)
    B = state.batch
    act = state.block_active.to(DT.F)
    inv_m_blocks = act / C.SHAPE_MASS
    block_moment = f32(G.BLOCK_MOMENT, dev)[state.block_shape.long()]
    inv_i_blocks = act / block_moment
    inv_m = torch.cat([f32(inv_m_robot, dev).expand(B, -1), inv_m_blocks], 1)
    inv_i = torch.cat([f32(inv_i_robot, dev).expand(B, -1), inv_i_blocks], 1)
    return inv_m, inv_i


def make_initial_state(batch: int, max_blocks: int, max_goals: int,
                       device) -> EnvState:
    """An all-zeros/parked template state for `batch` envs; tasks fill it
    in at reset."""
    nb = N_ROBOT_BODIES + max_blocks
    park = np.zeros((nb, 2), np.float32)
    for b in range(max_blocks):
        park[N_ROBOT_BODIES + b] = (PARK_POS + 4.0 * b, PARK_POS)
    maxc = max_contacts(max_blocks)

    def zeros(*shape, dtype=DT.F):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)

    return EnvState(
        pos=f32(park, device).repeat(batch, 1, 1),
        angle=zeros(nb),
        vel=zeros(nb, 2),
        omega=zeros(nb),
        v_bias=zeros(nb, 2),
        w_bias=zeros(nb),
        target_speed=zeros(),
        rel_turn_angle=zeros(),
        target_finger_angle=zeros(),
        block_shape=zeros(max_blocks, dtype=torch.int32),
        block_colour=zeros(max_blocks, dtype=torch.int32),
        block_active=zeros(max_blocks, dtype=torch.bool),
        goal_xyhw=zeros(max_goals, 4),
        goal_colour=zeros(max_goals, dtype=torch.int32),
        goal_active=zeros(max_goals, dtype=torch.bool),
        con_id=torch.full((batch, maxc), -1, dtype=torch.int32,
                          device=device),
        con_jn=zeros(maxc),
        con_jt=zeros(maxc),
        joint_acc=zeros(n_joint_acc(max_blocks)),
        aux=zeros(4, dtype=torch.int32),
        place_fail=zeros(dtype=torch.int32),
        phys=f32(C.PHYS_VAR_DEFAULTS, device).repeat(batch, 1),
        rng=zeros(2, dtype=torch.int64),
        t=zeros(dtype=torch.int32),
    )


def _rot(ca, sa, v):
    """Rotate local (2,) or (..., 2) vectors `v` by per-env (cos, sin)."""
    return torch.stack([ca * v[..., 0] - sa * v[..., 1],
                        sa * v[..., 0] + ca * v[..., 1]], dim=-1)


def place_robot(state: EnvState, pos, angle) -> EnvState:
    """Set the robot's 5 bodies to the canonical configuration for a given
    main-body pose, per env: `pos` (B, 2), `angle` (B,).  Fingers sit at
    their initial angular offsets and pinned positions, eyes aligned with
    the body."""
    dev = state.device
    pos = torch.as_tensor(pos, dtype=DT.F, device=dev)
    angle = torch.as_tensor(angle, dtype=DT.F, device=dev)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    new_pos = state.pos.clone()
    new_angle = state.angle.clone()
    new_pos[:, 0] = pos
    new_angle[:, 0] = angle
    rel = f32(G.ROBOT_GEOM['finger_rel_pos'], dev)          # (2, 2)
    deltas = f32(G.ROBOT_GEOM['finger_init_delta'], dev)    # (2,)
    for i in range(2):
        new_pos[:, 1 + i] = pos + _rot(ca[:, 0], sa[:, 0], rel[i])
        new_angle[:, 1 + i] = angle + deltas[i]
    for i in range(2):
        # eye bodies have no collision shapes; they stay at the robot
        # centre
        new_pos[:, 3 + i] = pos
        new_angle[:, 3 + i] = angle
    return state.replace(pos=new_pos, angle=new_angle)


def place_block(state: EnvState, idx: int, pos, angle, shape_type,
                colour) -> EnvState:
    """Activate block `idx` in every env with the given pose/type/colour
    (each a per-env (B, ...) tensor or a value broadcast to all envs)."""
    b = N_ROBOT_BODIES + idx
    dev = state.device
    new = {k: getattr(state, k).clone() for k in (
        'pos', 'angle', 'block_shape', 'block_colour', 'block_active')}
    new['pos'][:, b] = torch.as_tensor(pos, dtype=DT.F, device=dev)
    new['angle'][:, b] = torch.as_tensor(angle, dtype=DT.F,
                                         device=dev)
    new['block_shape'][:, idx] = torch.as_tensor(shape_type,
                                                 dtype=torch.int32,
                                                 device=dev)
    new['block_colour'][:, idx] = torch.as_tensor(colour, dtype=torch.int32,
                                                  device=dev)
    new['block_active'][:, idx] = True
    return state.replace(**new)
