"""MoveToRegion: drive the robot into the goal region.

The PyTorch counterpart of ``magical_tpu/tasks/move_to_region.py``
(reference: magical/benchmarks/move_to_region.py).
"""

import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch.core.state import make_initial_state
from magical_tpu_torch.tasks import base as B
from magical_tpu_torch.tasks import randomize as R

MAX_BLOCKS = 1         # no blocks in this task (slot kept inactive)
MAX_GOALS = 1
EP_LEN = 40

DEFAULT_ROBOT_POSE = ((0.058, 0.53), -2.13)
DEFAULT_GOAL_XYHW = (-0.62, -0.17, 0.76, 0.75)   # x, y top-left, h, w
DEFAULT_GOAL_COLOUR = C.ShapeColour.BLUE

VARIANTS = ('Demo', 'TestJitter', 'TestColour', 'TestLayout', 'TestDynamics',
            'TestAll')
VARIANT_FLAGS = {
    'Demo': B.Flags(),
    'TestJitter': B.Flags(layout_minor=True),
    'TestColour': B.Flags(colour=True),
    'TestLayout': B.Flags(layout_full=True),
    'TestDynamics': B.Flags(dynamics=True),
    'TestAll': B.Flags(colour=True, layout_full=True, dynamics=True),
}


def reset_from_draws(d: B.Draws, flags: B.Flags):
    """Reset `d.batch` envs.  Draws only where the variant randomises
    something."""
    batch, dev = d.batch, d.device
    state = make_initial_state(batch, MAX_BLOCKS, MAX_GOALS, dev)
    state = state.replace(phys=B.phys_from_draws(d, flags))

    x, y, h, w = DEFAULT_GOAL_XYHW
    h, w = B.per_env(h, batch, dev), B.per_env(w, batch, dev)
    if flags.any_layout:
        # move_to_region.py:32-45 — hw randomised before pose
        bound = C.JITTER_TARGET_BOUND if flags.layout_minor else None
        h, w = R.hw_from_uniform(d.uniform('goal_hw', (2,)),
                                 C.RAND_GOAL_MIN_SIZE, C.RAND_GOAL_MAX_SIZE,
                                 current_hw=(h, w), linf_bound=bound)
    # goal body position = centre derived from the (possibly resampled)
    # h/w with the default top-left (entities.py:797)
    goal_c = torch.stack([x + w / 2.0, y - h / 2.0], -1)

    colour = torch.full((batch,), int(DEFAULT_GOAL_COLOUR), dtype=torch.int32,
                        device=dev)
    if flags.colour:
        colour = d.choice('colour', C.RAND_SHAPE_COLOURS)

    robot_pos, robot_ang = (B.per_env(v, batch, dev)
                            for v in DEFAULT_ROBOT_POSE)

    if flags.any_layout:
        # move_to_region.py:66-83: entities = (goal, robot); goal rotation
        # never randomised; minor => pos bound for both, rot bound robot only
        pos_lim = C.JITTER_POS_BOUND if flags.layout_minor else None
        rot_lim = C.JITTER_ROT_BOUND if flags.layout_minor else None
        stack = B.Stack(2, batch, dev)
        gg = R.goal_placement_geom(h, w)
        zero = torch.zeros((batch,), dtype=torch.float32, device=dev)
        goal_c, _, ok = B.place(d, 'goal', gg, goal_c, zero, stack,
                                rand_rot=False, pos_linf_limit=pos_lim)
        stack.put(0, gg, goal_c, zero, ok=ok)
        rg = B.robot_geom(batch, dev)
        robot_pos, robot_ang, ok = B.place(
            d, 'robot', rg, robot_pos, robot_ang, stack,
            pos_linf_limit=pos_lim, rot_limit=rot_lim)
        stack.put(1, rg, robot_pos, robot_ang, ok=ok)
        state = state.replace(place_fail=stack.fails)

    cxcyhw = torch.stack([goal_c[:, 0], goal_c[:, 1], h, w], -1)[:, None, :]
    state = B.set_goals(state, cxcyhw, colour[:, None],
                        torch.ones((batch, 1), dtype=torch.bool, device=dev))
    return B.finalize_robot(state, robot_pos, robot_ang)


def score(state):
    """move_to_region.py:85-94 — binary: robot COM inside the goal box."""
    inside = B.com_in_goal(state.pos[..., 0, :], state.goal_xyhw[..., 0, :])
    return inside.to(torch.float32)


TASK = B.TaskDef(
    name='MoveToRegion', max_blocks=MAX_BLOCKS, max_goals=MAX_GOALS,
    ep_len=EP_LEN, variants=VARIANTS, variant_flags=VARIANT_FLAGS,
    reset_from_draws=reset_from_draws, score_fn=score,
    default_shapes=(int(C.ShapeType.SQUARE),), default_active=(False,))
