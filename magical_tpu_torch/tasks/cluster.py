"""ClusterColour / ClusterShape: sort blocks into per-colour or per-type
clusters.

The PyTorch counterpart of ``magical_tpu/tasks/cluster.py`` (reference:
magical/benchmarks/cluster.py).
"""

import functools

import numpy as np
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch.core.state import N_ROBOT_BODIES, make_initial_state
from magical_tpu_torch.tasks import base as B
from magical_tpu_torch.tasks import randomize as R

MAX_BLOCKS = 10
MAX_GOALS = 1      # unused
EP_LEN = 240
MIN_COUNT = 7      # cluster.py:82 randint(7, 10+1)
DEFAULT_COUNT = 8

SC = C.ShapeColour
ST = C.ShapeType

COLOUR_DEFAULTS = dict(
    robot_pose=((0.71692, -0.34374), 0.83693),
    colours=np.array([SC.BLUE, SC.BLUE, SC.BLUE, SC.GREEN, SC.GREEN, SC.RED,
                      SC.YELLOW, SC.YELLOW], np.int32),
    shapes=np.array([ST.CIRCLE, ST.STAR, ST.SQUARE, ST.PENTAGON, ST.PENTAGON,
                     ST.SQUARE, ST.STAR, ST.PENTAGON], np.int32),
    poses=np.array([(-0.5147, 0.14149), (-0.1347, -0.71414),
                    (-0.74247, -0.097592), (-0.077363, -0.42964),
                    (0.51978, 0.1853), (-0.5278, -0.21642),
                    (-0.54039, 0.48292), (-0.16761, 0.64303)], np.float32),
    angles=np.array([-0.38871, 1.0533, 1.1571, -0.64379, -1.1762, 2.9356,
                     0.072818, -2.3255], np.float32),
)
SHAPE_DEFAULTS = dict(
    robot_pose=((0.286, -0.202), -1.878),
    colours=np.array([SC.YELLOW, SC.BLUE, SC.RED, SC.RED, SC.GREEN,
                      SC.YELLOW, SC.BLUE, SC.GREEN], np.int32),
    shapes=np.array([ST.SQUARE, ST.PENTAGON, ST.PENTAGON, ST.PENTAGON,
                     ST.CIRCLE, ST.STAR, ST.STAR, ST.CIRCLE], np.int32),
    poses=np.array([(-0.414, 0.297), (0.068, 0.705), (0.821, 0.220),
                    (-0.461, -0.749), (0.867, -0.149), (-0.785, -0.140),
                    (-0.305, -0.226), (0.758, -0.708)], np.float32),
    angles=np.array([-1.731, 2.184, 0.650, -2.673, -2.215, -0.405, 1.341,
                     -2.140], np.float32),
)

VARIANTS = B.FULL_VARIANTS
VARIANT_FLAGS = B.FULL_VARIANT_FLAGS


def _pad(arr):
    """A default table padded with zeros to MAX_BLOCKS rows."""
    a = np.asarray(arr)
    return np.concatenate([a, np.zeros((MAX_BLOCKS - a.shape[0],)
                                       + a.shape[1:], a.dtype)])


def _shuffled_with_all(d: B.Draws, name: str, values, n):
    """cluster.py:91-98 / 102-109: one of each value, padded with random
    choices up to n, then shuffled, per env over the MAX_BLOCKS slots
    (slots >= n unused): draws ``name/fill`` (the choices) and
    ``name/perm`` (the shuffle's sort keys)."""
    dev = d.device
    nv = len(values)
    base = torch.as_tensor(np.asarray(values, np.int32), device=dev)
    fill = d.choice(f'{name}/fill', values, (MAX_BLOCKS,))
    idx = torch.arange(MAX_BLOCKS, device=dev)
    vals = torch.where(idx < nv, base[torch.clamp(idx, 0, nv - 1)], fill)
    # shuffle the first n entries: sort random keys, unused slots last
    u = d.uniform(f'{name}/perm', (MAX_BLOCKS,))
    u = torch.where(idx < n[:, None], u, 2.0)
    return vals.gather(1, torch.argsort(u, dim=-1, stable=True))


def _reset(generator: torch.Generator, batch: int, flags: B.Flags, device,
           defaults):
    return _reset_from_draws(B.Draws(generator, batch, device), flags,
                             defaults)


def _reset_from_draws(d: B.Draws, flags: B.Flags, defaults):
    batch, dev = d.batch, d.device
    state = make_initial_state(batch, MAX_BLOCKS, MAX_GOALS, dev)
    state = state.replace(phys=B.phys_from_draws(d, flags))

    if flags.count:
        n = d.randint('count', MIN_COUNT, MAX_BLOCKS + 1)
    else:
        n = torch.full((batch,), DEFAULT_COUNT, dtype=torch.int32, device=dev)
    active = torch.arange(MAX_BLOCKS, device=dev) < n[:, None]

    colours = B.per_env(_pad(defaults['colours']), batch, dev, torch.int32)
    shapes = B.per_env(_pad(defaults['shapes']), batch, dev, torch.int32)
    if flags.colour:
        colours = _shuffled_with_all(d, 'colours', C.RAND_SHAPE_COLOURS, n)
    if flags.shape:
        shapes = _shuffled_with_all(d, 'shapes', C.RAND_SHAPE_TYPES, n)

    poses = B.per_env(_pad(defaults['poses']), batch, dev)
    angles = B.per_env(_pad(defaults['angles']), batch, dev)
    robot_pos = B.per_env(defaults['robot_pose'][0], batch, dev)
    robot_ang = B.per_env(defaults['robot_pose'][1], batch, dev)

    if flags.any_layout:
        pos_lim, rot_lim = B.jitter_limits(flags)
        # order per cluster.py:148-161: robot, then blocks
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


def _score(state, by_colour: bool):
    """cluster.py:166-216 — centroid-margin clustering score."""
    chars = state.block_colour if by_colour else state.block_shape
    nvals = 4 if by_colour else 7
    pts = state.pos[:, N_ROBOT_BODIES:]                      # (B, MB, 2)
    active = state.block_active
    dev = state.device

    # per-value centroids over present values
    val_ids = torch.arange(nvals, device=dev)
    member = (chars[:, None, :] == val_ids[:, None]) \
        & active[:, None, :]                                 # (B, V, MB)
    counts = member.sum(-1)
    present = counts > 0
    sums = torch.where(member[..., None], pts[:, None], 0.0).sum(2)
    centroids = torch.where(present[..., None],
                            sums / torch.clamp(counts, min=1)[..., None], 0.0)

    # per-block: sqrt(own SSE) < sqrt(nearest other SSE) - 2*own SSE
    diff = pts[:, :, None, :] - centroids[:, None, :, :]     # (B, MB, V, 2)
    sses = diff[..., 0] ** 2 + diff[..., 1] ** 2
    own = sses.gather(2, chars[..., None].long())[..., 0]
    bad = torch.where(present[:, None, :]
                      & (val_ids != chars[..., None]), sses, float('inf'))
    nearest_bad = bad.amin(-1)
    margin = 2.0 * own
    correct = (torch.sqrt(own) < torch.sqrt(nearest_bad) - margin) & active
    n = torch.clamp(active.sum(-1), min=1)
    frac = correct.sum(-1).to(torch.float32) / n.to(torch.float32)
    thresh = 0.75
    return torch.clamp(frac - thresh, min=0.0) / (1.0 - thresh)


COLOUR_TASK = B.TaskDef(
    name='ClusterColour', max_blocks=MAX_BLOCKS, max_goals=MAX_GOALS,
    ep_len=EP_LEN, variants=VARIANTS, variant_flags=VARIANT_FLAGS,
    reset_fn=functools.partial(_reset, defaults=COLOUR_DEFAULTS),
    reset_from_draws=functools.partial(_reset_from_draws,
                                       defaults=COLOUR_DEFAULTS),
    score_fn=functools.partial(_score, by_colour=True),
    default_shapes=tuple(int(s) for s in COLOUR_DEFAULTS['shapes']),
    default_active=(True,) * MAX_BLOCKS)

SHAPE_TASK = B.TaskDef(
    name='ClusterShape', max_blocks=MAX_BLOCKS, max_goals=MAX_GOALS,
    ep_len=EP_LEN, variants=VARIANTS, variant_flags=VARIANT_FLAGS,
    reset_fn=functools.partial(_reset, defaults=SHAPE_DEFAULTS),
    reset_from_draws=functools.partial(_reset_from_draws,
                                       defaults=SHAPE_DEFAULTS),
    score_fn=functools.partial(_score, by_colour=False),
    default_shapes=tuple(int(s) for s in SHAPE_DEFAULTS['shapes']),
    default_active=(True,) * MAX_BLOCKS)
