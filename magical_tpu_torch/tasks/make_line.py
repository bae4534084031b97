"""MakeLine: arrange all blocks into a straight line.

The PyTorch counterpart of ``magical_tpu/tasks/make_line.py`` (reference:
magical/benchmarks/make_line.py).
"""

import numpy as np
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch.core.state import N_ROBOT_BODIES, make_initial_state
from magical_tpu_torch.tasks import base as B
from magical_tpu_torch.tasks import randomize as R

MAX_BLOCKS = 4
MAX_GOALS = 1      # unused
EP_LEN = 180
MIN_BLOCKS = 3

INLIER_DIST = C.SHAPE_RAD * 1.5     # make_line.py:10,90
MAX_SEP = C.SHAPE_RAD * 3.5         # make_line.py:11,91

ROBOT_POSE = ((0.702, -0.255), 0.347)
SC = C.ShapeColour
ST = C.ShapeType
DEFAULT_COLOURS = np.array([SC.BLUE, SC.YELLOW, SC.RED, SC.GREEN], np.int32)
DEFAULT_SHAPES = np.array([ST.STAR, ST.CIRCLE, ST.STAR, ST.PENTAGON],
                          np.int32)
DEFAULT_POSES = np.array([(0.790, -0.820), (-0.177, 0.383),
                          (-0.051, -0.128), (-0.292, -0.745)], np.float32)
DEFAULT_ANGLES = np.array([-0.721, -1.733, 2.696, -0.159], np.float32)

VARIANTS = B.FULL_VARIANTS
VARIANT_FLAGS = B.FULL_VARIANT_FLAGS


def reset_from_draws(d: B.Draws, flags: B.Flags):
    batch, dev = d.batch, d.device
    state = make_initial_state(batch, MAX_BLOCKS, MAX_GOALS, dev)
    state = state.replace(phys=B.phys_from_draws(d, flags))

    if flags.count:
        n = d.randint('count', MIN_BLOCKS, MAX_BLOCKS + 1)
    else:
        n = torch.full((batch,), MAX_BLOCKS, dtype=torch.int32, device=dev)
    active = torch.arange(MAX_BLOCKS, device=dev) < n[:, None]

    colours = B.per_env(DEFAULT_COLOURS, batch, dev, torch.int32)
    shapes = B.per_env(DEFAULT_SHAPES, batch, dev, torch.int32)
    if flags.colour:
        colours = d.choice('colours', C.RAND_SHAPE_COLOURS, (MAX_BLOCKS,))
    if flags.shape:
        shapes = d.choice('shapes', C.RAND_SHAPE_TYPES, (MAX_BLOCKS,))

    poses = B.per_env(DEFAULT_POSES, batch, dev)
    angles = B.per_env(DEFAULT_ANGLES, batch, dev)
    robot_pos = B.per_env(ROBOT_POSE[0], batch, dev)
    robot_ang = B.per_env(ROBOT_POSE[1], batch, dev)

    if flags.any_layout:
        pos_lim, rot_lim = B.jitter_limits(flags)
        # order per make_line.py:124-140: robot first, then blocks
        stack = B.Stack(1 + MAX_BLOCKS, batch, dev)
        rg = B.robot_geom(batch, dev)
        robot_pos, robot_ang, ok = B.place(
            d, 'robot', rg, robot_pos, robot_ang, stack,
            pos_linf_limit=pos_lim, rot_limit=rot_lim)
        stack.put(0, rg, robot_pos, robot_ang, ok=ok)
        new_p, new_a = [], []
        for i in range(MAX_BLOCKS):
            bg = R.block_placement_geom(shapes[:, i])
            p, a, ok = B.place(d, f'block{i}', bg, poses[:, i], angles[:, i],
                               stack, pos_linf_limit=pos_lim,
                               rot_limit=rot_lim)
            stack.put(1 + i, bg, p, a, present=active[:, i], ok=ok)
            new_p.append(p)
            new_a.append(a)
        poses = torch.stack(new_p, 1)
        angles = torch.stack(new_a, 1)
        state = state.replace(place_fail=stack.fails)

    state = B.set_blocks(state, shapes, colours, poses, angles, active)
    return B.finalize_robot(state, robot_pos, robot_ang)


def longest_line(points, active, inlier_dist=INLIER_DIST, max_sep=MAX_SEP):
    """make_line.py:31-71 — exhaustive pairwise RANSAC with an adjacency
    (max separation) constraint, batched over envs and over the static
    block-slot pairs, with an active mask.

    points (B, MB, 2), active (B, MB) bool; returns (B,) i32: the most
    blocks on one line through a pair of active blocks, each within
    `inlier_dist` of it and at most `max_sep` from the next along it."""
    B_, mb = active.shape
    dev = points.device
    ii, jj = B.device_constant(
        tuple(tuple(int(i) for i in x) for x in np.triu_indices(mb, 1)), dev,
        torch.int64)
    npair = ii.shape[0]
    offs = points[:, None, :, :] - points[:, ii, None, :]    # (B, NP, MB, 2)
    pj_off = offs[:, torch.arange(npair, device=dev), jj]    # (B, NP, 2)
    norm = torch.clamp(torch.sqrt(pj_off[..., 0] * pj_off[..., 0]
                                  + pj_off[..., 1] * pj_off[..., 1]),
                       min=1e-9)
    u = pj_off / norm[..., None]
    proj = offs[..., 0] * u[..., None, 0] + offs[..., 1] * u[..., None, 1]
    rej = offs - proj[..., None] * u[:, :, None, :]
    dists = torch.sqrt(rej[..., 0] * rej[..., 0] + rej[..., 1] * rej[..., 1])
    inlier = (dists <= inlier_dist) & active[:, None, :]
    # sort the inliers' projections (non-inliers pushed to +inf)
    svals = torch.sort(torch.where(inlier, proj, float('inf')), -1).values
    m = inlier.sum(-1)                                       # (B, NP)
    seps = torch.abs(torch.diff(svals, dim=-1))
    sep_ok = (seps <= max_sep) & (torch.arange(mb - 1, device=dev)
                                  < (m - 1)[..., None])
    # the longest run of consecutive True, +1
    run = torch.zeros((B_, npair), dtype=torch.int32, device=dev)
    longest = run
    for k in range(mb - 1):
        run = torch.where(sep_ok[..., k], run + 1, 0)
        longest = torch.maximum(longest, run)
    pair_valid = active[:, ii] & active[:, jj]
    bests = torch.where(pair_valid, longest + 1, 0)
    best0 = torch.clamp(active.sum(-1), max=1).to(torch.int32)
    return torch.maximum(best0, bests.amax(-1).to(torch.int32))


def score(state):
    """make_line.py:142-152 — 0 outliers -> 1, 1 outlier -> 0.5, 2+ -> 0."""
    active = state.block_active
    line_len = longest_line(state.pos[:, N_ROBOT_BODIES:], active)
    n = active.sum(-1).to(torch.int32)
    min_len = torch.clamp(n - 2, min=2)
    denom = torch.clamp(n - min_len, min=1)
    return torch.clamp((line_len - min_len).to(torch.float32)
                       / denom.to(torch.float32), 0.0, 1.0)


TASK = B.TaskDef(
    name='MakeLine', max_blocks=MAX_BLOCKS, max_goals=MAX_GOALS,
    ep_len=EP_LEN, variants=VARIANTS, variant_flags=VARIANT_FLAGS,
    reset_from_draws=reset_from_draws, score_fn=score,
    default_shapes=tuple(int(s) for s in DEFAULT_SHAPES),
    default_active=(True,) * MAX_BLOCKS)
