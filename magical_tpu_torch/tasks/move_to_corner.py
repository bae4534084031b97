"""MoveToCorner: push the block to the top-left corner.

The PyTorch counterpart of ``magical_tpu/tasks/move_to_corner.py``
(reference: magical/benchmarks/move_to_corner.py).  Variants registered
in benchmarks/__init__.py:406-451 (no TestLayout or TestCountPlus for this
task).
"""

import math

import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch.core.state import make_initial_state
from magical_tpu_torch.tasks import base as B
from magical_tpu_torch.tasks import randomize as R

MAX_BLOCKS = 1
MAX_GOALS = 1          # unused (kept >=1 for static-shape friendliness)
EP_LEN = 80

ROBOT_POSE = ((0.4, 0.0), 0.55 * math.pi)
BLOCK_POSE = ((0.1, -0.65), 0.13 * math.pi)

VARIANTS = ('Demo', 'TestJitter', 'TestColour', 'TestShape', 'TestDynamics',
            'TestAll')
VARIANT_FLAGS = {
    'Demo': B.Flags(),
    'TestJitter': B.Flags(layout_minor=True),
    'TestColour': B.Flags(colour=True),
    'TestShape': B.Flags(shape=True),
    'TestDynamics': B.Flags(dynamics=True),
    # TestAll uses jitter-level pose randomisation (rand_poses) per
    # benchmarks/__init__.py:444-450
    'TestAll': B.Flags(colour=True, shape=True, layout_minor=True,
                       dynamics=True),
}


def reset_from_draws(d: B.Draws, flags: B.Flags):
    """Reset `d.batch` envs.  Draws only where the variant randomises
    something."""
    batch, dev = d.batch, d.device
    state = make_initial_state(batch, MAX_BLOCKS, MAX_GOALS, dev)
    state = state.replace(phys=B.phys_from_draws(d, flags))

    colour = torch.full((batch,), int(C.ShapeColour.RED), dtype=torch.int32,
                        device=dev)
    shape = torch.full((batch,), int(C.ShapeType.SQUARE), dtype=torch.int32,
                       device=dev)
    if flags.colour:
        colour = d.choice('colour', C.RAND_SHAPE_COLOURS)
    if flags.shape:
        shape = d.choice('shape', C.RAND_SHAPE_TYPES)

    robot_pos, robot_ang = (B.per_env(v, batch, dev) for v in ROBOT_POSE)
    block_pos, block_ang = (B.per_env(v, batch, dev) for v in BLOCK_POSE)
    if flags.any_layout:
        pos_lim, rot_lim = B.jitter_limits(flags)
        stack = B.Stack(2, batch, dev)
        rg = B.robot_geom(batch, dev)
        # order matches move_to_corner.py:57-64: robot first, then shape
        robot_pos, robot_ang, ok = B.place(
            d, 'robot', rg, robot_pos, robot_ang, stack,
            pos_linf_limit=pos_lim, rot_limit=rot_lim)
        stack.put(0, rg, robot_pos, robot_ang, ok=ok)
        bg = R.block_placement_geom(shape)
        block_pos, block_ang, ok = B.place(
            d, 'block', bg, block_pos, block_ang, stack,
            pos_linf_limit=pos_lim, rot_limit=rot_lim)
        stack.put(1, bg, block_pos, block_ang, ok=ok)
        state = state.replace(place_fail=stack.fails)

    state = B.set_blocks(state, shape[:, None], colour[:, None],
                         block_pos[:, None], block_ang[:, None],
                         torch.ones((batch, 1), dtype=torch.bool,
                                    device=dev))
    return B.finalize_robot(state, robot_pos, robot_ang)


def score(state):
    """move_to_corner.py:66-75 — linear ramp on block distance to (-1, 1)."""
    p = state.pos[..., 5, :]
    d = B.device_constant((-1.0, 1.0), p.device) - p
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    succeed = math.sqrt(2) / 2
    furthest = math.sqrt(2)
    return torch.clamp((furthest - dist) / (furthest - succeed), 0.0, 1.0)


def debug_shaped_reward(state):
    """move_to_corner.py:84-98 — dense debug reward for RL sanity checks."""
    shape_pos = state.pos[..., 5, :]
    robot_pos = state.pos[..., 0, :]
    s = shape_pos - B.device_constant((0.0, 1.0), shape_pos.device)
    r = robot_pos - shape_pos
    s2c = torch.sqrt(s[..., 0] * s[..., 0] + s[..., 1] * s[..., 1])
    r2s = torch.sqrt(r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1])
    shaping = -s2c / 5.0 - torch.clamp(r2s, min=0.2) / 20.0
    return shaping + score(state)


TASK = B.TaskDef(
    name='MoveToCorner', max_blocks=MAX_BLOCKS, max_goals=MAX_GOALS,
    ep_len=EP_LEN, variants=VARIANTS, variant_flags=VARIANT_FLAGS,
    reset_from_draws=reset_from_draws, score_fn=score,
    default_shapes=(int(C.ShapeType.SQUARE),), default_active=(True,))
