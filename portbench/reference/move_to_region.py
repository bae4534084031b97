"""The benchmark's frozen copy of ``magical_tpu_torch/tasks/move_to_region.py``,
part of the plain reference that decides a run's `correct`.  It
imports nothing of the port, so that no later change to the port
moves the yardstick; its float type is ``dtype.F``.

MoveToRegion: drive the robot into the goal region.

The PyTorch counterpart of ``magical_tpu/tasks/move_to_region.py``
(reference: magical/benchmarks/move_to_region.py).  The reset draws from
its generator in the port's order: the goal's height and width, the
colour, then the goal's and the robot's placement proposals.
"""

import torch

from portbench.reference import dtype as DT

from portbench.reference import constants as C
from portbench.reference.state import make_initial_state
from portbench.reference import base as B
from portbench.reference import randomize as R

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


def reset(generator: torch.Generator, batch: int, flags: B.Flags, device):
    """Reset `batch` envs.  Draws from `generator` only where the variant
    randomises something."""
    state = make_initial_state(batch, MAX_BLOCKS, MAX_GOALS, device)
    state = state.replace(phys=B.sample_phys(generator, batch, flags,
                                             device))

    x, y, h, w = DEFAULT_GOAL_XYHW
    h = B.per_env(h, batch, device)
    w = B.per_env(w, batch, device)
    if flags.any_layout:
        # move_to_region.py:32-45: the size is drawn before the pose
        bound = C.JITTER_TARGET_BOUND if flags.layout_minor else None
        h, w = R.randomise_hw(generator, batch, C.RAND_GOAL_MIN_SIZE,
                              C.RAND_GOAL_MAX_SIZE, device,
                              current_hw=(h, w), linf_bound=bound)
    # the goal body sits at the centre of the box whose top-left corner is
    # the default one (entities.py:797)
    goal_c = torch.stack([x + w / 2.0, y - h / 2.0], -1)

    colour = torch.full((batch,), int(DEFAULT_GOAL_COLOUR), dtype=torch.int32,
                        device=device)
    if flags.colour:
        colour = B.choice(generator, C.RAND_SHAPE_COLOURS, batch, device)

    robot_pos = B.per_env(DEFAULT_ROBOT_POSE[0], batch, device)
    robot_ang = B.per_env(DEFAULT_ROBOT_POSE[1], batch, device)

    if flags.any_layout:
        # move_to_region.py:66-83: the goal, then the robot; the goal is
        # never rotated; minor jitter bounds both positions and the
        # robot's angle
        pos_lim = C.JITTER_POS_BOUND if flags.layout_minor else None
        rot_lim = C.JITTER_ROT_BOUND if flags.layout_minor else None
        stack = B.Stack(2, batch, device)
        gg = R.goal_placement_geom(h, w)
        zero = torch.zeros((batch,), dtype=DT.F, device=device)
        goal_c, _, ok = R.place_entity(
            generator, gg, goal_c, zero, stack.placed(), stack.mask,
            rand_rot=False, pos_linf_limit=pos_lim)
        stack.put(0, gg, goal_c, zero, ok=ok)
        rg = B.robot_geom(batch, device)
        robot_pos, robot_ang, ok = R.place_entity(
            generator, rg, robot_pos, robot_ang, stack.placed(), stack.mask,
            pos_linf_limit=pos_lim, rot_limit=rot_lim)
        stack.put(1, rg, robot_pos, robot_ang, ok=ok)
        state = state.replace(place_fail=stack.fails)

    cxcyhw = torch.stack([goal_c[:, 0], goal_c[:, 1], h, w], -1)[:, None, :]
    state = B.set_goals(state, cxcyhw, colour[:, None],
                        torch.ones((batch, 1), dtype=torch.bool,
                                   device=device))
    return B.finalize_robot(state, robot_pos, robot_ang)


def score(state):
    """move_to_region.py:85-94: 1 where the robot's centre of mass is
    inside the goal box, else 0."""
    inside = B.com_in_goal(state.pos[..., 0, :], state.goal_xyhw[..., 0, :])
    return inside.to(DT.F)


TASK = B.TaskDef(
    name='MoveToRegion', max_blocks=MAX_BLOCKS, max_goals=MAX_GOALS,
    ep_len=EP_LEN, variants=VARIANTS, variant_flags=VARIANT_FLAGS,
    reset_fn=reset, score_fn=score,
    default_shapes=(int(C.ShapeType.SQUARE),), default_active=(False,))
