"""Reference-parity reset sampling (host-side).

The counterpart of ``magical_tpu/data/parity.py``, numpy over the port's
own constants and geometry.  The reference seeds `np.random.RandomState`
(base_env.py:133-140) and consumes draws in a task-specific order during
`on_reset`, including an unbounded rejection-placement loop
(geom.py:116-264).  This module replays that exact draw order with the
MT19937 stream of ``magical_tpu_torch.native`` and a numpy overlap tester
mirroring `space.shape_query`, producing scene specs that are
bit-compatible with the reference's resets (up to narrowphase epsilon at
accept/reject boundaries).  `state_from_spec` turns a batch of specs into
an `EnvState` on a device.  Use it for golden-parity replays of reference
demos; the device reset path (`tasks/*.py`) is the production path.

Draw-order provenance per task is cited inline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch import geometry as G
from magical_tpu_torch.native import NativeRandomState

ARENA_L, ARENA_R, ARENA_B, ARENA_T = C.ARENA_BOUNDS_LRBT
MAX_TRIES = 10000      # geom.py:201


@dataclasses.dataclass
class SceneSpec:
    robot_pose: Tuple[Tuple[float, float], float]
    block_shapes: List[int]
    block_colours: List[int]
    block_poses: List[Tuple[Tuple[float, float], float]]
    goal_cxcyhw: List[Tuple[float, float, float, float]]
    goal_colours: List[int]
    phys: np.ndarray


# ---------------------------------------------------------------------------
# numpy overlap testing (shape_query semantics)
# ---------------------------------------------------------------------------

def _rot(v, a):
    c, s = math.cos(a), math.sin(a)
    return np.asarray([[c, -s], [s, c]], np.float64) @ np.asarray(v).T


class _Entity:
    """Convex sub-shape collection in world frame."""

    def __init__(self, parts):
        # parts: list of (verts (n,2) float64, radius)
        self.parts = parts

    @staticmethod
    def robot(pos, angle):
        parts = [(np.asarray([pos], np.float64), C.ROBOT_RAD)]
        rg = G.ROBOT_GEOM
        c, s = math.cos(angle), math.sin(angle)
        R = np.asarray([[c, -s], [s, c]])
        for side in range(2):
            delta = float(rg['finger_init_delta'][side])
            rel = np.asarray(rg['finger_rel_pos'][side], np.float64)
            cd, sd = math.cos(angle + delta), math.sin(angle + delta)
            Rf = np.asarray([[cd, -sd], [sd, cd]])
            fpos = np.asarray(pos) + R @ rel
            for k in range(2):
                poly = np.asarray(rg['finger_polys'][side, k], np.float64)
                parts.append((poly @ Rf.T + fpos, 0.0))
        return _Entity(parts)

    @staticmethod
    def block(shape_code, pos, angle):
        c, s = math.cos(angle), math.sin(angle)
        R = np.asarray([[c, -s], [s, c]])
        parts = []
        for k in range(G.KSUB):
            if not G.BLOCK_SUB_ACTIVE[shape_code, k]:
                continue
            nv = int(G.BLOCK_SUB_NV[shape_code, k])
            verts = np.asarray(G.BLOCK_VERTS[shape_code, k][:nv],
                               np.float64)
            parts.append((verts @ R.T + np.asarray(pos),
                          float(G.BLOCK_SUB_RADIUS[shape_code, k])))
        return _Entity(parts)

    @staticmethod
    def goal(cx, cy, h, w):
        verts = np.asarray([(cx + w / 2, cy + h / 2), (cx - w / 2,
                                                       cy + h / 2),
                            (cx - w / 2, cy - h / 2),
                            (cx + w / 2, cy - h / 2)], np.float64)
        return _Entity([(verts, 0.0)])


def _part_overlap(va, ra, vb, rb):
    rsum = ra + rb
    if len(va) == 1 and len(vb) == 1:
        return np.linalg.norm(vb[0] - va[0]) < rsum
    if len(va) == 1:
        return _circle_poly_dist(va[0], vb) < rsum
    if len(vb) == 1:
        return _circle_poly_dist(vb[0], va) < rsum
    return _sat_sep(va, vb) < rsum


def _circle_poly_dist(c, verts):
    n = len(verts)
    seps = []
    inside = True
    mind = np.inf
    for i in range(n):
        a, b = verts[i], verts[(i + 1) % n]
        e = b - a
        nrm = np.asarray([e[1], -e[0]])
        nrm = nrm / max(np.linalg.norm(nrm), 1e-12)
        sep = float(nrm @ (c - a))
        if sep > 0:
            inside = False
        t = np.clip((c - a) @ e / max(e @ e, 1e-12), 0, 1)
        mind = min(mind, float(np.linalg.norm(c - (a + t * e))))
        seps.append(sep)
    return max(seps) if inside else mind


def _sat_sep(va, vb):
    best = -np.inf
    for verts, other in ((va, vb), (vb, va)):
        n = len(verts)
        for i in range(n):
            a, b = verts[i], verts[(i + 1) % n]
            e = b - a
            ln = np.linalg.norm(e)
            if ln < 1e-12:
                continue
            nrm = np.asarray([e[1], -e[0]]) / ln
            sep = float(np.min(other @ nrm) - verts[i] @ nrm)
            best = max(best, sep)
    return best


def _overlaps(ent_a: _Entity, ent_b: _Entity) -> bool:
    for va, ra in ent_a.parts:
        for vb, rb in ent_b.parts:
            if _part_overlap(va, ra, vb, rb):
                return True
    return False


def _hits_wall(ent: _Entity) -> bool:
    for verts, rad in ent.parts:
        for wn, wo in zip(np.asarray([[1, 0], [-1, 0], [0, 1], [0, -1]],
                                     np.float64), [-1.0] * 4):
            if np.min(verts @ wn) - wo - rad < 0:
                return True
    return False


# ---------------------------------------------------------------------------
# pm_randomise_pose / pm_randomise_all_poses replicas (geom.py:116-341)
# ---------------------------------------------------------------------------

class _Placer:
    def __init__(self, rng):
        self.rng = rng
        self.obstacles: List[_Entity] = []   # entities with collisions on

    def randomise_pose(self, make_entity, cur_pos, cur_angle,
                       rand_pos=True, rand_rot=True,
                       pos_linf=None, rot_limit=None,
                       ignore: Optional[List[_Entity]] = None):
        """Exact draw-order replica of geom.pm_randomise_pose."""
        if pos_linf is not None:
            x_mm = (max(ARENA_L, cur_pos[0] - pos_linf),
                    min(ARENA_R, cur_pos[0] + pos_linf))
            y_mm = (max(ARENA_B, cur_pos[1] - pos_linf),
                    min(ARENA_T, cur_pos[1] + pos_linf))
        else:
            x_mm = (ARENA_L, ARENA_R)
            y_mm = (ARENA_B, ARENA_T)
        if rot_limit is not None:
            r_mm = (cur_angle - rot_limit, cur_angle + rot_limit)
        else:
            r_mm = (-math.pi, math.pi)
        ignore = ignore or []
        obstacles = [o for o in self.obstacles if o not in ignore]
        for _ in range(MAX_TRIES):
            if rand_pos:
                px = self.rng.uniform(*x_mm)
                py = self.rng.uniform(*y_mm)
            else:
                px, py = cur_pos
            if rand_rot:
                ang = self.rng.uniform(*r_mm)
            else:
                ang = cur_angle
            ent = make_entity((px, py), ang)
            if _hits_wall(ent):
                continue
            if any(_overlaps(ent, o) for o in obstacles):
                continue
            return (px, py), ang, ent
        raise RuntimeError('placement failed (PlacementError analogue)')


def randomise_hw(rng, min_side, max_side, current_hw=None, linf=None):
    """geom.py:344-359 draw order (one vectorised uniform of size 2)."""
    minima = np.asarray([min_side, min_side], np.float64)
    maxima = np.asarray([max_side, max_side], np.float64)
    if linf is not None:
        cur = np.asarray(current_hw, np.float64)
        minima = np.maximum(minima, cur - linf)
        maxima = np.minimum(maxima, cur + linf)
    h = rng.uniform(minima[0], maxima[0])
    w = rng.uniform(minima[1], maxima[1])
    return h, w


def sample_phys(rng, dynamics):
    """base_env.py:198-203 + phys_vars.py:70-83 (declaration order)."""
    if not dynamics:
        return np.asarray(C.PHYS_VAR_DEFAULTS)
    return np.asarray([rng.uniform(float(lo), float(hi))
                       for lo, hi in zip(C.PHYS_VAR_LO, C.PHYS_VAR_HI)],
                      np.float32)


# ---------------------------------------------------------------------------
# Task samplers (exact on_reset draw order)
# ---------------------------------------------------------------------------

_COLOUR_VALUES = [int(c) for c in C.RAND_SHAPE_COLOURS]
_SHAPE_VALUES = [int(s) for s in C.RAND_SHAPE_TYPES]


def sample_move_to_corner(rng, flags) -> SceneSpec:
    """move_to_corner.py:31-64."""
    phys = sample_phys(rng, flags.dynamics)
    robot_pose = ((0.4, 0.0), 0.55 * math.pi)
    shape_pose = ((0.1, -0.65), 0.13 * math.pi)
    colour = int(C.ShapeColour.RED)
    shape = int(C.ShapeType.SQUARE)
    if flags.colour:
        colour = rng.choice(_COLOUR_VALUES)
    if flags.shape:
        shape = rng.choice(_SHAPE_VALUES)
    if flags.layout_minor:
        placer = _Placer(rng)
        rp, ra, ent = placer.randomise_pose(
            _Entity.robot, robot_pose[0], robot_pose[1],
            pos_linf=C.JITTER_POS_BOUND, rot_limit=C.JITTER_ROT_BOUND)
        robot_pose = (rp, ra)
        placer.obstacles.append(ent)
        bp, ba, _ = placer.randomise_pose(
            lambda p, a: _Entity.block(shape, p, a), shape_pose[0],
            shape_pose[1], pos_linf=C.JITTER_POS_BOUND,
            rot_limit=C.JITTER_ROT_BOUND)
        shape_pose = (bp, ba)
    return SceneSpec(robot_pose, [shape], [colour], [shape_pose], [], [],
                     phys)


def sample_move_to_region(rng, flags) -> SceneSpec:
    """move_to_region.py:30-83."""
    phys = sample_phys(rng, flags.dynamics)
    x, y, h, w = (-0.62, -0.17, 0.76, 0.75)
    if flags.layout_minor or flags.layout_full:
        bound = C.JITTER_TARGET_BOUND if flags.layout_minor else None
        h, w = randomise_hw(rng, C.RAND_GOAL_MIN_SIZE, C.RAND_GOAL_MAX_SIZE,
                            current_hw=(h, w), linf=bound)
    colour = int(C.ShapeColour.BLUE)
    if flags.colour:
        colour = rng.choice(_COLOUR_VALUES)
    goal_c = (x + w / 2, y - h / 2)
    robot_pose = ((0.058, 0.53), -2.13)
    if flags.layout_minor or flags.layout_full:
        pos_lim = C.JITTER_POS_BOUND if flags.layout_minor else None
        rot_lim = C.JITTER_ROT_BOUND if flags.layout_minor else None
        placer = _Placer(rng)
        gp, _, gent = placer.randomise_pose(
            lambda p, a: _Entity.goal(p[0], p[1], h, w), goal_c, 0.0,
            rand_rot=False, pos_linf=pos_lim)
        goal_c = gp
        placer.obstacles.append(gent)
        rp, ra, _ = placer.randomise_pose(
            _Entity.robot, robot_pose[0], robot_pose[1],
            pos_linf=pos_lim, rot_limit=rot_lim)
        robot_pose = (rp, ra)
    return SceneSpec(robot_pose, [], [], [],
                     [(goal_c[0], goal_c[1], h, w)], [colour], phys)


def sample_match_regions(rng, flags) -> SceneSpec:
    """match_regions.py:44-191."""
    phys = sample_phys(rng, flags.dynamics)
    robot_pose = ((-0.5, 0.1), -math.pi * 1.2)
    if flags.colour:
        target_colour = rng.choice(_COLOUR_VALUES)
    else:
        target_colour = int(C.ShapeColour.GREEN)
    distractor_colours = [c for c in _COLOUR_VALUES if c != target_colour]
    th, tw = 0.7, 0.6
    if flags.layout_minor or flags.layout_full:
        bound = C.JITTER_TARGET_BOUND if flags.layout_minor else None
        th, tw = randomise_hw(rng, C.RAND_GOAL_MIN_SIZE,
                              C.RAND_GOAL_MAX_SIZE, current_hw=(th, tw),
                              linf=bound)
    goal_c = (0.1 + tw / 2, 0.7 - th / 2)

    d_types_default = [[], [int(C.ShapeType.PENTAGON)],
                       [int(C.ShapeType.CIRCLE), int(C.ShapeType.PENTAGON)]]
    t_poses_default = [((0.8, -0.7), 2.37), ((-0.68, 0.72), 1.28)]
    d_poses_default = [[], [((-0.05, -0.2), -1.09)],
                       [((-0.75, -0.55), 2.78), ((0.3, -0.82), -1.15)]]
    if flags.count:
        target_count = rng.randint(1, 3)
        d_counts = [rng.randint(0, 3) for _ in distractor_colours]
    else:
        target_count = 2
        d_counts = [len(lst) for lst in d_types_default]
    if flags.shape:
        t_types = [rng.choice(_SHAPE_VALUES) for _ in range(target_count)]
        d_types = [[rng.choice(_SHAPE_VALUES) for _ in range(c)]
                   for c in d_counts]
    else:
        t_types = [int(C.ShapeType.STAR), int(C.ShapeType.SQUARE)]
        d_types = d_types_default
    if flags.layout_full:
        t_poses = [((0.0, 0.0), 0.0)] * target_count
        d_poses = [[((0.0, 0.0), 0.0)] * c for c in d_counts]
    else:
        t_poses = t_poses_default
        d_poses = d_poses_default

    shapes, colours, poses = [], [], []
    for ty, po in zip(t_types, t_poses):
        shapes.append(ty); colours.append(target_colour); poses.append(po)
    for dc, tys, pos_l in zip(distractor_colours, d_types, d_poses):
        for ty, po in zip(tys, pos_l):
            shapes.append(ty); colours.append(dc); poses.append(po)

    if flags.layout_minor or flags.layout_full:
        pos_lim = C.JITTER_POS_BOUND if flags.layout_minor else None
        rot_lim = C.JITTER_ROT_BOUND if flags.layout_minor else None
        placer = _Placer(rng)
        gp, _, gent = placer.randomise_pose(
            lambda p, a: _Entity.goal(p[0], p[1], th, tw), goal_c, 0.0,
            rand_rot=False, pos_linf=pos_lim)
        goal_c = gp
        placer.obstacles.append(gent)
        rp, ra, rent = placer.randomise_pose(
            _Entity.robot, robot_pose[0], robot_pose[1], pos_linf=pos_lim,
            rot_limit=rot_lim)
        robot_pose = (rp, ra)
        placer.obstacles.append(rent)
        for i, (ty, (po, an)) in enumerate(zip(shapes, poses)):
            bp, ba, bent = placer.randomise_pose(
                lambda p, a, ty=ty: _Entity.block(ty, p, a), po, an,
                pos_linf=pos_lim, rot_limit=rot_lim)
            poses[i] = (bp, ba)
            placer.obstacles.append(bent)
    return SceneSpec(robot_pose, shapes, colours, poses,
                     [(goal_c[0], goal_c[1], th, tw)], [target_colour],
                     phys)


def sample_make_line(rng, flags) -> SceneSpec:
    """make_line.py:93-140."""
    phys = sample_phys(rng, flags.dynamics)
    robot_pose = ((0.702, -0.255), 0.347)
    shapes = [int(C.ShapeType.STAR), int(C.ShapeType.CIRCLE),
              int(C.ShapeType.STAR), int(C.ShapeType.PENTAGON)]
    colours = [int(C.ShapeColour.BLUE), int(C.ShapeColour.YELLOW),
               int(C.ShapeColour.RED), int(C.ShapeColour.GREEN)]
    poses = [((0.790, -0.820), -0.721), ((-0.177, 0.383), -1.733),
             ((-0.051, -0.128), 2.696), ((-0.292, -0.745), -0.159)]
    if flags.count:
        n = rng.randint(3, 5)
        poses = poses[:1] * n
    else:
        n = 4
    if flags.colour:
        colours = rng.choice(_COLOUR_VALUES, size=n)
    if flags.shape:
        shapes = rng.choice(_SHAPE_VALUES, size=n)
    shapes, colours, poses = shapes[:n], colours[:n], poses[:n]
    if flags.layout_minor or flags.layout_full:
        pos_lim = C.JITTER_POS_BOUND if flags.layout_minor else None
        rot_lim = C.JITTER_ROT_BOUND if flags.layout_minor else None
        placer = _Placer(rng)
        rp, ra, rent = placer.randomise_pose(
            _Entity.robot, robot_pose[0], robot_pose[1], pos_linf=pos_lim,
            rot_limit=rot_lim)
        robot_pose = (rp, ra)
        placer.obstacles.append(rent)
        for i in range(n):
            bp, ba, bent = placer.randomise_pose(
                lambda p, a, ty=shapes[i]: _Entity.block(ty, p, a),
                poses[i][0], poses[i][1], pos_linf=pos_lim,
                rot_limit=rot_lim)
            poses[i] = (bp, ba)
            placer.obstacles.append(bent)
    return SceneSpec(robot_pose, list(shapes), list(colours), poses, [],
                     [], phys)


def sample_find_dupe(rng, flags) -> SceneSpec:
    """find_dupe.py:72-201.  Block order: outside blocks then query."""
    phys = sample_phys(rng, flags.dynamics)
    robot_pose = ((-0.57, 0.25), 3.83)
    q_colour = int(C.ShapeColour.YELLOW)
    q_shape = int(C.ShapeType.PENTAGON)
    out_cols = [int(C.ShapeColour.GREEN), int(C.ShapeColour.RED),
                int(C.ShapeColour.RED), int(C.ShapeColour.YELLOW),
                int(C.ShapeColour.BLUE), q_colour]
    out_shapes = [int(C.ShapeType.PENTAGON), int(C.ShapeType.CIRCLE),
                  int(C.ShapeType.CIRCLE), int(C.ShapeType.SQUARE),
                  int(C.ShapeType.STAR), q_shape]
    n_out = 6
    if flags.count:
        n_out = rng.randint(1, 6) + 1
    n_dis = n_out - 1
    if flags.colour:
        q_colour = rng.choice(_COLOUR_VALUES)
        out_cols = rng.choice(_COLOUR_VALUES, size=n_dis) + [q_colour]
    if flags.shape:
        q_shape = rng.choice(_SHAPE_VALUES)
        out_shapes = rng.choice(_SHAPE_VALUES, size=n_dis) + [q_shape]
    out_cols, out_shapes = out_cols[:n_out], out_shapes[:n_out]
    x, y, h, w = (-0.72, -0.22, 0.67, 0.72)
    if flags.layout_minor or flags.layout_full:
        bound = C.JITTER_TARGET_BOUND if flags.layout_minor else None
        h, w = randomise_hw(rng, C.RAND_GOAL_MIN_SIZE,
                            C.RAND_GOAL_MAX_SIZE, current_hw=(h, w),
                            linf=bound)
    goal_c = (x + w / 2, y - h / 2)
    q_pose = ((-0.33, -0.49), -0.51)
    out_poses = [((-0.066751, 0.7552), -2.9266),
                 ((-0.05195, 0.31468), 1.5418),
                 ((0.57528, -0.46865), -2.2141),
                 ((0.40594, -0.74977), 0.24582),
                 ((0.45254, 0.3681), -1.0834),
                 ((0.76849, -0.10652), 0.10028)][:n_out]
    if flags.count:
        out_poses = [((0.0, 0.0), 0.0)] * n_out
    if flags.layout_minor or flags.layout_full:
        pos_lim = C.JITTER_POS_BOUND if flags.layout_minor else None
        rot_lim = C.JITTER_ROT_BOUND if flags.layout_minor else None
        placer = _Placer(rng)
        gp, _, gent = placer.randomise_pose(
            lambda p, a: _Entity.goal(p[0], p[1], h, w), goal_c, 0.0,
            rand_rot=False, pos_linf=pos_lim)
        goal_c = gp
        placer.obstacles.append(gent)
        rp, ra, rent = placer.randomise_pose(
            _Entity.robot, robot_pose[0], robot_pose[1], pos_linf=pos_lim,
            rot_limit=rot_lim)
        robot_pose = (rp, ra)
        placer.obstacles.append(rent)
        for i in range(n_out):
            bp, ba, bent = placer.randomise_pose(
                lambda p, a, ty=out_shapes[i]: _Entity.block(ty, p, a),
                out_poses[i][0], out_poses[i][1], pos_linf=pos_lim,
                rot_limit=rot_lim)
            out_poses[i] = (bp, ba)
            placer.obstacles.append(bent)
        # query block placed inside the sensor, ignoring it
        # (find_dupe.py:180-198)
        q_lim = max(0.0, min(h, w) / 2 - C.SHAPE_RAD / 2)
        if flags.layout_minor:
            q_lim = min(C.JITTER_POS_BOUND, q_lim)
        qp, qa, _ = placer.randomise_pose(
            lambda p, a: _Entity.block(q_shape, p, a), goal_c, q_pose[1],
            pos_linf=q_lim, rot_limit=rot_lim, ignore=[gent])
        q_pose = (qp, qa)
    shapes = list(out_shapes) + [q_shape]
    colours = list(out_cols) + [q_colour]
    poses = list(out_poses) + [q_pose]
    return SceneSpec(robot_pose, shapes, colours, poses,
                     [(goal_c[0], goal_c[1], h, w)], [q_colour], phys)


def sample_fix_colour(rng, flags) -> SceneSpec:
    """fix_colour.py:67-191.  Region i <-> block i."""
    phys = sample_phys(rng, flags.dynamics)
    robot_pose = ((0.368, 0.586), 0.718)
    region_cols = [int(C.ShapeColour.GREEN), int(C.ShapeColour.GREEN),
                   int(C.ShapeColour.RED)]
    block_cols = [int(C.ShapeColour.GREEN), int(C.ShapeColour.GREEN),
                  int(C.ShapeColour.BLUE)]
    block_shapes = [int(C.ShapeType.PENTAGON), int(C.ShapeType.SQUARE),
                    int(C.ShapeType.PENTAGON)]
    block_poses = [((0.289, 0.030), 0.307), ((0.133, -0.561), 1.699),
                   ((-0.336, 0.000), -1.529)]
    region_xyhws = [(-0.032, 0.348, 0.427, 0.468),
                    (0.019, -0.391, 0.460, 0.458),
                    (-0.681, 0.196, 0.498, 0.418)]
    n = 3
    if flags.count:
        n = rng.randint(2, 4)
        block_poses = block_poses[:1] * n
        region_xyhws = region_xyhws[:1] * n
    if flags.colour:
        region_cols = rng.choice(_COLOUR_VALUES, size=n)
        block_cols = list(region_cols)
        odd = rng.randint(0, n)
        new_idx = rng.randint(0, 3)
        if _COLOUR_VALUES[new_idx] == block_cols[odd]:
            new_idx += 1
        block_cols[odd] = _COLOUR_VALUES[new_idx]
    if flags.shape:
        block_shapes = rng.choice(_SHAPE_VALUES, size=n)
    region_cols = region_cols[:n]
    block_cols = block_cols[:n]
    block_shapes = block_shapes[:n]
    if flags.layout_minor or flags.layout_full:
        bound = C.JITTER_TARGET_BOUND if flags.layout_minor else None
        region_xyhws = [
            (x, y, *randomise_hw(rng, 0.4, 0.5, current_hw=hw, linf=bound))
            for x, y, *hw in region_xyhws]
    goal_cs = [(x + w / 2, y - h / 2) for x, y, h, w in region_xyhws]
    if flags.layout_minor or flags.layout_full:
        pos_lim = C.JITTER_POS_BOUND if flags.layout_minor else None
        rot_lim = C.JITTER_ROT_BOUND if flags.layout_minor else None
        placer = _Placer(rng)
        gents = []
        for i in range(n):
            h, w = region_xyhws[i][2], region_xyhws[i][3]
            gp, _, gent = placer.randomise_pose(
                lambda p, a, h=h, w=w: _Entity.goal(p[0], p[1], h, w),
                goal_cs[i], 0.0, rand_rot=False, pos_linf=pos_lim)
            goal_cs[i] = gp
            placer.obstacles.append(gent)
            gents.append(gent)
        rp, ra, rent = placer.randomise_pose(
            _Entity.robot, robot_pose[0], robot_pose[1], pos_linf=pos_lim,
            rot_limit=rot_lim)
        robot_pose = (rp, ra)
        placer.obstacles.append(rent)
        # The reference shifts every block to its sensor's centre BEFORE
        # the per-block placement loop (fix_colour.py:168-175), so while
        # block i is being placed, blocks >i sit at their sensors'
        # centres and ARE collidable obstacles.
        provisional = []
        for i in range(n):
            ent = _Entity.block(block_shapes[i], goal_cs[i],
                                block_poses[i][1])
            provisional.append(ent)
            placer.obstacles.append(ent)
        for i in range(n):
            h, w = region_xyhws[i][2], region_xyhws[i][3]
            b_lim = max(0.0, min(h, w) / 2 - C.SHAPE_RAD)
            if flags.layout_minor:
                b_lim = min(C.JITTER_POS_BOUND, b_lim)
            placer.obstacles.remove(provisional[i])
            bp, ba, bent = placer.randomise_pose(
                lambda p, a, ty=block_shapes[i]: _Entity.block(ty, p, a),
                goal_cs[i], block_poses[i][1], pos_linf=b_lim,
                rot_limit=rot_lim, ignore=[gents[i]])
            block_poses[i] = (bp, ba)
            placer.obstacles.append(bent)
    goals = [(c[0], c[1], xyhw[2], xyhw[3])
             for c, xyhw in zip(goal_cs, region_xyhws)]
    return SceneSpec(robot_pose, list(block_shapes), list(block_cols),
                     block_poses, goals, list(region_cols), phys)


def _sample_cluster(rng, flags, defaults) -> SceneSpec:
    """cluster.py:67-161."""
    phys = sample_phys(rng, flags.dynamics)
    robot_pose = defaults['robot_pose']
    colours = [int(c) for c in defaults['colours']]
    shapes = [int(s) for s in defaults['shapes']]
    poses = [((float(p[0]), float(p[1])), float(a))
             for p, a in zip(defaults['poses'], defaults['angles'])]
    n = 8
    if flags.count:
        n = rng.randint(7, 11)
        poses = [((0.0, 0.0), 0.0)] * n
    if flags.colour:
        colours = list(_COLOUR_VALUES)
        colours.extend([rng.choice(_COLOUR_VALUES)
                        for _ in range(n - len(colours))])
        rng.shuffle(colours)
    if flags.shape:
        shapes = list(_SHAPE_VALUES)
        shapes.extend([rng.choice(_SHAPE_VALUES)
                       for _ in range(n - len(shapes))])
        rng.shuffle(shapes)
    colours, shapes, poses = colours[:n], shapes[:n], poses[:n]
    if flags.layout_minor or flags.layout_full:
        pos_lim = C.JITTER_POS_BOUND if flags.layout_minor else None
        rot_lim = C.JITTER_ROT_BOUND if flags.layout_minor else None
        placer = _Placer(rng)
        rp, ra, rent = placer.randomise_pose(
            _Entity.robot, robot_pose[0], robot_pose[1], pos_linf=pos_lim,
            rot_limit=rot_lim)
        robot_pose = (rp, ra)
        placer.obstacles.append(rent)
        for i in range(n):
            bp, ba, bent = placer.randomise_pose(
                lambda p, a, ty=shapes[i]: _Entity.block(ty, p, a),
                poses[i][0], poses[i][1], pos_linf=pos_lim,
                rot_limit=rot_lim)
            poses[i] = (bp, ba)
            placer.obstacles.append(bent)
    return SceneSpec(robot_pose, shapes, colours, poses, [], [], phys)


def sample_cluster_colour(rng, flags):
    from magical_tpu_torch.tasks.cluster import COLOUR_DEFAULTS
    return _sample_cluster(rng, flags, COLOUR_DEFAULTS)


def sample_cluster_shape(rng, flags):
    from magical_tpu_torch.tasks.cluster import SHAPE_DEFAULTS
    return _sample_cluster(rng, flags, SHAPE_DEFAULTS)


SAMPLERS = {
    'MoveToCorner': sample_move_to_corner,
    'MoveToRegion': sample_move_to_region,
    'MatchRegions': sample_match_regions,
    'MakeLine': sample_make_line,
    'FindDupe': sample_find_dupe,
    'FixColour': sample_fix_colour,
    'ClusterColour': sample_cluster_colour,
    'ClusterShape': sample_cluster_shape,
}


def sample_scene(task_name: str, seed: int, flags) -> SceneSpec:
    rng = NativeRandomState(seed)
    return SAMPLERS[task_name](rng, flags)


def state_from_spec(specs: Union[SceneSpec, Sequence[SceneSpec]],
                    max_blocks: int, max_goals: int, device='cuda'):
    """A batched `EnvState` of sampled scene specs, one env per spec, on
    `device` (the card unless the caller asks for the CPU).  The state is
    built on the host, as JAX's state_from_spec builds one env, and copied
    to the device once.  Specs may hold fewer blocks or goals than
    `max_blocks`/`max_goals`: the missing ones stay parked and inactive."""
    from magical_tpu_torch.api.batched_env import resolve_device
    from magical_tpu_torch.core import state as S
    device = resolve_device(device)
    if isinstance(specs, SceneSpec):
        specs = [specs]
    n = len(specs)
    st = S.make_initial_state(n, max_blocks, max_goals, 'cpu')
    st = st.replace(phys=torch.as_tensor(np.stack(
        [np.asarray(s.phys, np.float32) for s in specs])))
    active = np.zeros((n, max_blocks), bool)
    for i in range(max(len(s.block_shapes) for s in specs)):
        # envs without block i keep its parked pose; block_active is set
        # for all envs at the end
        b = S.N_ROBOT_BODIES + i
        pos, ang = st.pos[:, b].clone(), st.angle[:, b].clone()
        shape, colour = st.block_shape[:, i].clone(), \
            st.block_colour[:, i].clone()
        for e, s in enumerate(specs):
            if i < len(s.block_shapes):
                (x, y), a = s.block_poses[i]
                pos[e] = torch.tensor((x, y), dtype=torch.float32)
                ang[e] = float(a)
                shape[e], colour[e] = int(s.block_shapes[i]), \
                    int(s.block_colours[i])
                active[e, i] = True
        st = S.place_block(st, i, pos, ang, shape, colour)
    st = st.replace(block_active=torch.from_numpy(active))
    goal_xyhw, goal_colour = st.goal_xyhw.clone(), st.goal_colour.clone()
    goal_active = st.goal_active.clone()
    for e, s in enumerate(specs):
        k = len(s.goal_cxcyhw)
        if k:
            goal_xyhw[e, :k] = torch.tensor(s.goal_cxcyhw,
                                            dtype=torch.float32)
            goal_colour[e, :k] = torch.tensor(s.goal_colours,
                                              dtype=torch.int32)
            goal_active[e, :k] = True
    st = st.replace(goal_xyhw=goal_xyhw, goal_colour=goal_colour,
                    goal_active=goal_active)
    st = S.place_robot(
        st, torch.tensor([s.robot_pose[0] for s in specs],
                         dtype=torch.float32),
        torch.tensor([s.robot_pose[1] for s in specs], dtype=torch.float32))
    return S.EnvState(**{f.name: getattr(st, f.name).to(device)
                         for f in dataclasses.fields(st)})
