"""FixColour: remove the one colour-mismatched block from its region.

The PyTorch counterpart of ``magical_tpu/tasks/fix_colour.py`` (reference:
magical/benchmarks/fix_colour.py).  Slot layout: region i <-> block i
(index-aligned), i < n_regions.  The only family with three goal regions.
"""

import numpy as np
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch.core.state import N_ROBOT_BODIES, make_initial_state
from magical_tpu_torch.tasks import base as B
from magical_tpu_torch.tasks import randomize as R

MAX_BLOCKS = 3
MAX_GOALS = 3
EP_LEN = 60
MIN_REGIONS = 2
MIN_GOAL_SIZE = 0.4     # fix_colour.py:13-14
MAX_GOAL_SIZE = 0.5

SC = C.ShapeColour
ST = C.ShapeType
DEFAULT_ROBOT_POSE = ((0.368, 0.586), 0.718)
DEFAULT_BLOCK_COLOURS = np.array([SC.GREEN, SC.GREEN, SC.BLUE], np.int32)
DEFAULT_BLOCK_SHAPES = np.array([ST.PENTAGON, ST.SQUARE, ST.PENTAGON],
                                np.int32)
DEFAULT_BLOCK_POSES = np.array(
    [(0.289, 0.030), (0.133, -0.561), (-0.336, 0.000)], np.float32)
DEFAULT_BLOCK_ANGLES = np.array([0.307, 1.699, -1.529], np.float32)
DEFAULT_REGION_XYHWS = np.array([
    (-0.032, 0.348, 0.427, 0.468),
    (0.019, -0.391, 0.460, 0.458),
    (-0.681, 0.196, 0.498, 0.418)], np.float32)
DEFAULT_REGION_COLOURS = np.array([SC.GREEN, SC.GREEN, SC.RED], np.int32)

VARIANTS = B.FULL_VARIANTS
VARIANT_FLAGS = B.FULL_VARIANT_FLAGS


def reset_from_draws(d: B.Draws, flags: B.Flags):
    batch, dev = d.batch, d.device
    state = make_initial_state(batch, MAX_BLOCKS, MAX_GOALS, dev)
    state = state.replace(phys=B.phys_from_draws(d, flags))

    if flags.count:
        n = d.randint('count', MIN_REGIONS, MAX_GOALS + 1)
    else:
        n = torch.full((batch,), MAX_GOALS, dtype=torch.int32, device=dev)
    slot = torch.arange(MAX_BLOCKS, device=dev)
    active = slot < n[:, None]

    i32 = torch.int32
    region_colours = B.per_env(DEFAULT_REGION_COLOURS, batch, dev, i32)
    block_colours = B.per_env(DEFAULT_BLOCK_COLOURS, batch, dev, i32)
    if flags.colour:
        # fix_colour.py:85-94: regions random; one block is the odd one out
        region_colours = d.choice('region_colours', C.RAND_SHAPE_COLOURS,
                                  (MAX_BLOCKS,))
        odd = d.randint('odd_idx', 0, n).long()
        new_col = d.randint('new_col_idx', 0, 3)
        odd_region = region_colours.gather(1, odd[:, None])[:, 0]
        new_col = torch.where(new_col == odd_region, new_col + 1, new_col)
        block_colours = torch.where(slot == odd[:, None], new_col[:, None],
                                    region_colours)

    shapes = B.per_env(DEFAULT_BLOCK_SHAPES, batch, dev, i32)
    if flags.shape:
        shapes = d.choice('shapes', C.RAND_SHAPE_TYPES, (MAX_BLOCKS,))

    xyhws = B.per_env(DEFAULT_REGION_XYHWS, batch, dev)      # (B, MG, 4)
    if flags.count:
        # fix_colour.py:80-82: counts reuse the first default entry
        xyhws = xyhws[:, :1].expand(batch, MAX_GOALS, 4)
    hws = xyhws[..., 2:]
    if flags.any_layout:
        bound = C.JITTER_TARGET_BOUND if flags.layout_minor else None
        hw = [R.hw_from_uniform(d.uniform(f'goal_hw{i}', (2,)),
                                MIN_GOAL_SIZE, MAX_GOAL_SIZE,
                                current_hw=(hws[:, i, 0], hws[:, i, 1]),
                                linf_bound=bound)
              for i in range(MAX_GOALS)]
        hws = torch.stack([torch.stack([h for h, _ in hw], 1),
                           torch.stack([w for _, w in hw], 1)], -1)
    goal_c = torch.stack([xyhws[..., 0] + hws[..., 1] / 2.0,
                          xyhws[..., 1] - hws[..., 0] / 2.0], -1)  # (B,MG,2)

    poses = B.per_env(DEFAULT_BLOCK_POSES, batch, dev)
    angles = B.per_env(DEFAULT_BLOCK_ANGLES, batch, dev)
    robot_pos = B.per_env(DEFAULT_ROBOT_POSE[0], batch, dev)
    robot_ang = B.per_env(DEFAULT_ROBOT_POSE[1], batch, dev)

    if flags.any_layout:
        pos_lim, rot_lim = B.jitter_limits(flags)
        # fix_colour.py:143-165: (regions..., robot) placed ignoring blocks
        stack = B.Stack(1 + MAX_GOALS + MAX_BLOCKS, batch, dev)
        zero = torch.zeros((batch,), dtype=torch.float32, device=dev)
        new_gc = []
        for i in range(MAX_GOALS):
            gg = R.goal_placement_geom(hws[:, i, 0], hws[:, i, 1])
            c, _, ok = B.place(d, f'goal{i}', gg, goal_c[:, i], zero, stack,
                               rand_rot=False, pos_linf_limit=pos_lim)
            stack.put(i, gg, c, zero, present=active[:, i], ok=ok)
            new_gc.append(c)
        goal_c = torch.stack(new_gc, 1)
        rg = B.robot_geom(batch, dev)
        robot_pos, robot_ang, ok = B.place(
            d, 'robot', rg, robot_pos, robot_ang, stack,
            pos_linf_limit=pos_lim, rot_limit=rot_lim)
        stack.put(MAX_GOALS, rg, robot_pos, robot_ang, ok=ok)

        # fix_colour.py:167-188: each block placed inside its own region
        # (ignoring that region's sensor); other regions/blocks collide.
        new_p, new_a = [], []
        for i in range(MAX_BLOCKS):
            b_lim = torch.clamp(torch.minimum(hws[:, i, 0], hws[:, i, 1])
                                / 2.0 - C.SHAPE_RAD, min=0.0)
            if flags.layout_minor:
                b_lim = torch.clamp(b_lim, max=C.JITTER_POS_BOUND)
            bg = R.block_placement_geom(shapes[:, i])
            p, a, ok = B.place(d, f'block{i}', bg, goal_c[:, i],
                               angles[:, i], stack, stack.mask_without(i),
                               pos_linf_limit=b_lim, rot_limit=rot_lim)
            stack.put(MAX_GOALS + 1 + i, bg, p, a, present=active[:, i],
                      ok=ok)
            new_p.append(p)
            new_a.append(a)
        poses = torch.stack(new_p, 1)
        angles = torch.stack(new_a, 1)
        state = state.replace(place_fail=stack.fails)

    state = B.set_blocks(state, shapes, block_colours, poses, angles, active)
    state = B.set_goals(state, torch.cat([goal_c, hws], -1), region_colours,
                        active)
    return B.finalize_robot(state, robot_pos, robot_ang)


def score(state):
    """fix_colour.py:193-202 — binary: every region's COM-overlap set must
    equal its target list (odd region empty, others keep their block)."""
    bp = state.pos[:, N_ROBOT_BODIES:]                       # (B, MB, 2)
    act = state.block_active[:, None, :]                     # (B, 1, MB)
    inside = B.com_in_goal(bp[:, None], state.goal_xyhw[:, :, None]) & act
    block_matches = state.block_colour[:, None, :] \
        == state.goal_colour[:, :, None]                     # (B, MG, MB)
    # target membership: block g iff its colour matches region g
    dev = state.device
    own = torch.arange(MAX_BLOCKS, device=dev)[None, :] \
        == torch.arange(MAX_GOALS, device=dev)[:, None]
    want = own & block_matches & act
    region_ok = (inside == want).all(-1)
    return (region_ok | ~state.goal_active).all(-1).to(torch.float32)


TASK = B.TaskDef(
    name='FixColour', max_blocks=MAX_BLOCKS, max_goals=MAX_GOALS,
    ep_len=EP_LEN, variants=VARIANTS, variant_flags=VARIANT_FLAGS,
    reset_from_draws=reset_from_draws, score_fn=score,
    default_shapes=tuple(int(s) for s in DEFAULT_BLOCK_SHAPES),
    default_active=(True,) * MAX_BLOCKS)
