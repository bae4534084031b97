"""MatchRegions: push blocks of the goal's colour into the goal region.

The PyTorch counterpart of ``magical_tpu/tasks/match_regions.py``
(reference: magical/benchmarks/match_regions.py).  Block slot layout
(fixed, masked by per-env counts): slots 0-1: target blocks, slots
2+g*2+k: distractor group g in colour order (the three non-target colours,
in enum order).
"""

import math

import numpy as np
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch.core.state import N_ROBOT_BODIES, make_initial_state
from magical_tpu_torch.tasks import base as B
from magical_tpu_torch.tasks import randomize as R

MAX_BLOCKS = 8
MAX_GOALS = 1
EP_LEN = 120

ROBOT_POSE = ((-0.5, 0.1), -math.pi * 1.2)
GOAL_XYHW = (0.1, 0.7, 0.7, 0.6)          # x, y top-left, h, w

ST = C.ShapeType
# default slot tables (match_regions.py:80-99)
DEFAULT_SHAPES = np.array([ST.STAR, ST.SQUARE, ST.SQUARE, ST.SQUARE,
                           ST.PENTAGON, ST.SQUARE, ST.CIRCLE, ST.PENTAGON],
                          np.int32)
DEFAULT_POSES = np.array([
    (0.8, -0.7), (-0.68, 0.72),
    (0, 0), (0, 0),
    (-0.05, -0.2), (0, 0),
    (-0.75, -0.55), (0.3, -0.82)], np.float32)
DEFAULT_ANGLES = np.array([2.37, 1.28, 0, 0, -1.09, 0, 2.78, -1.15],
                          np.float32)
DEFAULT_T_COUNT = 2
DEFAULT_D_COUNTS = np.array([0, 1, 2], np.int32)

VARIANTS = B.FULL_VARIANTS
VARIANT_FLAGS = B.FULL_VARIANT_FLAGS


def _distractor_colours(target):
    """The three non-target colour codes in enum order, per env: (B,) ->
    (B, 3) (match_regions.py:56-58)."""
    all4 = torch.arange(4, dtype=torch.int32, device=target.device)
    key = torch.where(all4 == target[:, None], 99, all4)
    return torch.argsort(key, dim=-1, stable=True)[:, :3].to(torch.int32)


def _slot_masks(t_count, d_counts):
    """(B, 8) active mask and (8,) target mask from per-env counts
    (t_count (B,), d_counts (B, 3))."""
    slot = torch.arange(MAX_BLOCKS, device=t_count.device)
    is_target = slot < 2
    tgt_active = slot < t_count[:, None]
    g = torch.clamp(torch.div(slot - 2, 2, rounding_mode='floor'), 0, 2)
    k = torch.remainder(slot - 2, 2)
    dis_active = k < d_counts[:, g]
    return torch.where(is_target, tgt_active, dis_active), is_target


def reset(generator: torch.Generator, batch: int, flags: B.Flags, device):
    return reset_from_draws(B.Draws(generator, batch, device), flags)


def reset_from_draws(d: B.Draws, flags: B.Flags):
    batch, dev = d.batch, d.device
    state = make_initial_state(batch, MAX_BLOCKS, MAX_GOALS, dev)
    state = state.replace(phys=B.phys_from_draws(d, flags))

    i32 = torch.int32
    target_colour = torch.full((batch,), int(C.ShapeColour.GREEN), dtype=i32,
                               device=dev)
    if flags.colour:
        target_colour = d.choice('target_colour', C.RAND_SHAPE_COLOURS)
    dcols = _distractor_colours(target_colour)

    h = B.per_env(GOAL_XYHW[2], batch, dev)
    w = B.per_env(GOAL_XYHW[3], batch, dev)
    if flags.any_layout:
        bound = C.JITTER_TARGET_BOUND if flags.layout_minor else None
        h, w = R.hw_from_uniform(d.uniform('goal_hw', (2,)),
                                 C.RAND_GOAL_MIN_SIZE, C.RAND_GOAL_MAX_SIZE,
                                 current_hw=(h, w), linf_bound=bound)
    goal_c = torch.stack([GOAL_XYHW[0] + w / 2.0, GOAL_XYHW[1] - h / 2.0], -1)

    if flags.count:
        t_count = d.randint('target_count', 1, 3)
        d_counts = d.randint('distractor_counts', 0, 3, (3,))
    else:
        t_count = torch.full((batch,), DEFAULT_T_COUNT, dtype=i32, device=dev)
        d_counts = B.per_env(DEFAULT_D_COUNTS, batch, dev, i32)
    active, is_target = _slot_masks(t_count, d_counts)

    if flags.shape:
        shapes = d.choice('shapes', C.RAND_SHAPE_TYPES, (MAX_BLOCKS,))
    else:
        shapes = B.per_env(DEFAULT_SHAPES, batch, dev, i32)

    slot = torch.arange(MAX_BLOCKS, device=dev)
    g = torch.clamp(torch.div(slot - 2, 2, rounding_mode='floor'), 0, 2)
    colours = torch.where(is_target, target_colour[:, None], dcols[:, g])

    poses = B.per_env(DEFAULT_POSES, batch, dev)
    angles = B.per_env(DEFAULT_ANGLES, batch, dev)
    robot_pos = B.per_env(ROBOT_POSE[0], batch, dev)
    robot_ang = B.per_env(ROBOT_POSE[1], batch, dev)

    if flags.any_layout:
        pos_lim, rot_lim = B.jitter_limits(flags)
        # order per match_regions.py:168-188: sensor, robot, blocks;
        # goal rotation never randomised
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
        for i in range(MAX_BLOCKS):
            bg = R.block_placement_geom(shapes[:, i])
            p, a, ok = B.place(d, f'block{i}', bg, poses[:, i], angles[:, i],
                               stack, pos_linf_limit=pos_lim,
                               rot_limit=rot_lim)
            stack.put(2 + i, bg, p, a, present=active[:, i], ok=ok)
            new_p.append(p)
            new_a.append(a)
        poses = torch.stack(new_p, 1)
        angles = torch.stack(new_a, 1)
        state = state.replace(place_fail=stack.fails)

    state = B.set_blocks(state, shapes, colours, poses, angles, active)
    cxcyhw = torch.stack([goal_c[:, 0], goal_c[:, 1], h, w], -1)[:, None]
    state = B.set_goals(state, cxcyhw, target_colour[:, None],
                        torch.ones((batch, 1), dtype=torch.bool, device=dev))
    return B.finalize_robot(state, robot_pos, robot_ang)


def score(state):
    """match_regions.py:193-213 — target_frac_done * (1 - contamination)."""
    bp = state.pos[:, N_ROBOT_BODIES:]                      # (B, MB, 2)
    inside = B.com_in_goal(bp, state.goal_xyhw[:, :1]) & state.block_active
    target = state.block_active & (state.block_colour
                                   == state.goal_colour[:, :1])
    n_t = (target & inside).sum(-1).to(torch.float32)
    n_d = (inside & ~target).sum(-1).to(torch.float32)
    n_in = n_t + n_d
    n_targets = torch.clamp(target.sum(-1).to(torch.float32), min=1.0)
    frac = n_t / n_targets
    contam = torch.where(n_in > 0, n_d / torch.clamp(n_in, min=1.0), 0.0)
    return frac * (1.0 - contam)


TASK = B.TaskDef(
    name='MatchRegions', max_blocks=MAX_BLOCKS, max_goals=MAX_GOALS,
    ep_len=EP_LEN, variants=VARIANTS, variant_flags=VARIANT_FLAGS,
    reset_fn=reset, score_fn=score, reset_from_draws=reset_from_draws,
    default_shapes=tuple(int(s) for s in DEFAULT_SHAPES),
    default_active=(True, True, False, False, True, False, True, True))
