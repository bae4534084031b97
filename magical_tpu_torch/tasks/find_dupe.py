"""FindDupe: fetch a duplicate of the query block into the goal region.

The PyTorch counterpart of ``magical_tpu/tasks/find_dupe.py`` (reference:
magical/benchmarks/find_dupe.py).  Block slot layout: slots 0..5 = outside
blocks (slot n_out-1 is the guaranteed duplicate of the query), slot 6 =
the query block pre-placed inside the goal region.
"""

import numpy as np
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch.core.state import N_ROBOT_BODIES, make_initial_state
from magical_tpu_torch.tasks import base as B
from magical_tpu_torch.tasks import randomize as R

MAX_OUT = 6
MAX_BLOCKS = MAX_OUT + 1
QUERY_SLOT = MAX_OUT
MAX_GOALS = 1
EP_LEN = 100

SC = C.ShapeColour
ST = C.ShapeType
DEFAULT_QUERY_COLOUR = SC.YELLOW
DEFAULT_QUERY_SHAPE = ST.PENTAGON
DEFAULT_OUT_SHAPES = np.array(
    [ST.PENTAGON, ST.CIRCLE, ST.CIRCLE, ST.SQUARE, ST.STAR,
     DEFAULT_QUERY_SHAPE], np.int32)
DEFAULT_OUT_COLOURS = np.array(
    [SC.GREEN, SC.RED, SC.RED, SC.YELLOW, SC.BLUE, DEFAULT_QUERY_COLOUR],
    np.int32)
DEFAULT_OUT_POSES = np.array([
    (-0.066751, 0.7552), (-0.05195, 0.31468), (0.57528, -0.46865),
    (0.40594, -0.74977), (0.45254, 0.3681), (0.76849, -0.10652)], np.float32)
DEFAULT_OUT_ANGLES = np.array(
    [-2.9266, 1.5418, -2.2141, 0.24582, -1.0834, 0.10028], np.float32)
DEFAULT_ROBOT_POSE = ((-0.57, 0.25), 3.83)
DEFAULT_REGION_XYHW = (-0.72, -0.22, 0.67, 0.72)
DEFAULT_QUERY_POSE = ((-0.33, -0.49), -0.51)

VARIANTS = B.FULL_VARIANTS
VARIANT_FLAGS = B.FULL_VARIANT_FLAGS


def reset(generator: torch.Generator, batch: int, flags: B.Flags, device):
    return reset_from_draws(B.Draws(generator, batch, device), flags)


def reset_from_draws(d: B.Draws, flags: B.Flags):
    batch, dev = d.batch, d.device
    state = make_initial_state(batch, MAX_BLOCKS, MAX_GOALS, dev)
    state = state.replace(phys=B.phys_from_draws(d, flags))

    if flags.count:
        # find_dupe.py:84-88: 1-5 random blocks + 1 guaranteed duplicate
        n_out = d.randint('count', 1, 6) + 1
    else:
        n_out = torch.full((batch,), MAX_OUT, dtype=torch.int32, device=dev)
    slot = torch.arange(MAX_BLOCKS, device=dev)
    active = (slot < n_out[:, None]) | (slot == QUERY_SLOT)
    is_dupe = (slot == n_out[:, None] - 1) | (slot == QUERY_SLOT)

    i32 = torch.int32
    colours = B.per_env(np.append(DEFAULT_OUT_COLOURS, DEFAULT_QUERY_COLOUR),
                        batch, dev, i32)
    shapes = B.per_env(np.append(DEFAULT_OUT_SHAPES, DEFAULT_QUERY_SHAPE),
                       batch, dev, i32)
    if flags.colour:
        q_colour = d.choice('query_colour', C.RAND_SHAPE_COLOURS)
        rand_cols = d.choice('colours', C.RAND_SHAPE_COLOURS, (MAX_BLOCKS,))
        colours = torch.where(is_dupe, q_colour[:, None], rand_cols)
    if flags.shape:
        q_shape = d.choice('query_shape', C.RAND_SHAPE_TYPES)
        rand_shapes = d.choice('shapes', C.RAND_SHAPE_TYPES, (MAX_BLOCKS,))
        shapes = torch.where(is_dupe, q_shape[:, None], rand_shapes)
    q_colour = colours[:, QUERY_SLOT]

    # goal region (find_dupe.py:103-117) — coloured like the query block
    x, y, h0, w0 = DEFAULT_REGION_XYHW
    h = B.per_env(h0, batch, dev)
    w = B.per_env(w0, batch, dev)
    if flags.any_layout:
        bound = C.JITTER_TARGET_BOUND if flags.layout_minor else None
        h, w = R.hw_from_uniform(d.uniform('goal_hw', (2,)),
                                 C.RAND_GOAL_MIN_SIZE, C.RAND_GOAL_MAX_SIZE,
                                 current_hw=(h, w), linf_bound=bound)
    goal_c = torch.stack([x + w / 2.0, y - h / 2.0], -1)

    poses = B.per_env(np.concatenate([DEFAULT_OUT_POSES,
                                      [DEFAULT_QUERY_POSE[0]]]), batch, dev)
    angles = B.per_env(np.append(DEFAULT_OUT_ANGLES, DEFAULT_QUERY_POSE[1]),
                       batch, dev)
    robot_pos = B.per_env(DEFAULT_ROBOT_POSE[0], batch, dev)
    robot_ang = B.per_env(DEFAULT_ROBOT_POSE[1], batch, dev)

    if flags.any_layout:
        pos_lim, rot_lim = B.jitter_limits(flags)
        # order per find_dupe.py:157-178: sensor, robot, outside blocks
        # (query ignored); then the query block inside the sensor.
        stack = B.Stack(2 + MAX_BLOCKS, batch, dev)
        zero = torch.zeros((batch,), dtype=torch.float32, device=dev)
        gg = R.goal_placement_geom(h, w)
        goal_c, _, ok = B.place(d, 'goal', gg, goal_c, zero, stack,
                                rand_rot=False, pos_linf_limit=pos_lim)
        stack.put(0, gg, goal_c, zero, ok=ok)
        rg = B.robot_geom(batch, dev)
        robot_pos, robot_ang, ok = B.place(
            d, 'robot', rg, robot_pos, robot_ang, stack,
            pos_linf_limit=pos_lim, rot_limit=rot_lim)
        stack.put(1, rg, robot_pos, robot_ang, ok=ok)
        new_p, new_a = [], []
        for i in range(MAX_OUT):
            bg = R.block_placement_geom(shapes[:, i])
            p, a, ok = B.place(d, f'block{i}', bg, poses[:, i], angles[:, i],
                               stack, pos_linf_limit=pos_lim,
                               rot_limit=rot_lim)
            stack.put(2 + i, bg, p, a, present=active[:, i], ok=ok)
            new_p.append(p)
            new_a.append(a)

        # query block: shifted to the sensor centre then placed within it,
        # ignoring the sensor itself (find_dupe.py:180-198)
        q_lim = torch.clamp(torch.minimum(h, w) / 2.0 - C.SHAPE_RAD / 2.0,
                            min=0.0)
        if flags.layout_minor:
            q_lim = torch.clamp(q_lim, max=C.JITTER_POS_BOUND)
        qg = R.block_placement_geom(shapes[:, QUERY_SLOT])
        qp, qa, ok = B.place(d, 'query', qg, goal_c, angles[:, QUERY_SLOT],
                             stack, stack.mask_without(0),
                             pos_linf_limit=q_lim, rot_limit=rot_lim)
        state = state.replace(place_fail=stack.fails + (~ok).to(i32))
        poses = torch.stack(new_p + [qp], 1)
        angles = torch.stack(new_a + [qa], 1)

    state = B.set_blocks(state, shapes, colours, poses, angles, active)
    cxcyhw = torch.stack([goal_c[:, 0], goal_c[:, 1], h, w], -1)[:, None]
    state = B.set_goals(state, cxcyhw, q_colour[:, None],
                        torch.ones((batch, 1), dtype=torch.bool, device=dev))
    return B.finalize_robot(state, robot_pos, robot_ang)


def score(state):
    """find_dupe.py:203-216 — 1[>=2 matching blocks in region] * (1 -
    contamination)."""
    bp = state.pos[:, N_ROBOT_BODIES:]
    inside = B.com_in_goal(bp, state.goal_xyhw[:, :1]) & state.block_active
    q_colour = state.block_colour[:, QUERY_SLOT:QUERY_SLOT + 1]
    q_shape = state.block_shape[:, QUERY_SLOT:QUERY_SLOT + 1]
    target = state.block_active & (state.block_colour == q_colour) & \
        (state.block_shape == q_shape)
    n_t = (target & inside).sum(-1).to(torch.float32)
    n_d = (inside & ~target).sum(-1).to(torch.float32)
    n_in = n_t + n_d
    have_two = (n_t >= 2).to(torch.float32)
    contam = torch.where(n_in > 0, n_d / torch.clamp(n_in, min=1.0), 0.0)
    return have_two * (1.0 - contam)


TASK = B.TaskDef(
    name='FindDupe', max_blocks=MAX_BLOCKS, max_goals=MAX_GOALS,
    ep_len=EP_LEN, variants=VARIANTS, variant_flags=VARIANT_FLAGS,
    reset_fn=reset, score_fn=score, reset_from_draws=reset_from_draws,
    default_shapes=tuple(int(s) for s in DEFAULT_OUT_SHAPES)
    + (int(DEFAULT_QUERY_SHAPE),),
    default_active=(True,) * MAX_BLOCKS)
