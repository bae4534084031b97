"""Static geometry tables for the PyTorch port of the MAGICAL engine.

A numpy copy of ``magical_tpu/geometry.py`` (see ``constants.py`` for why
it is copied rather than imported); ``tests/test_torch_tables.py`` holds
the two equal.

The reference computes entity geometry at reset time with pymunk helpers
(convex decomposition, moment integrals, …); here everything is
precomputed ONCE in numpy and uploaded to the device as constant tables.
A block's collision geometry is a fixed-size set of convex sub-shapes
(max KSUB) of up to NV vertices each, so that the batched narrowphase can
look geometry up by integer shape-type code.

Reference geometry definitions:
  - regular polygons / star:  magical/geom.py:13-63
  - block construction:       magical/entities.py:614-711
  - finger construction:      magical/entities.py:193-214,279-331
"""

import math

import numpy as np

from magical_tpu_torch import constants as C

NV = 8      # max vertices per convex sub-shape (octagon)
KSUB = 6    # max convex sub-shapes per block (star: pentagon core + 5 tips)
N_SHAPE_TYPES = 7


# ---------------------------------------------------------------------------
# Vertex generators (mirroring geom.py semantics)
# ---------------------------------------------------------------------------

def regular_poly_circumrad(n_sides, side_length):
    return side_length / (2 * math.sin(math.pi / n_sides))


def regular_poly_circ_rad_to_side_length(n_sides, rad):
    """Side length giving the regular polygon the same area as a circle of
    radius `rad` (geom.py:18-22)."""
    p_n = math.pi / n_sides
    return 2 * rad * math.sqrt(p_n * math.tan(p_n))


def regular_poly_apothem_to_side_length(n_sides, apothem):
    return 2 * apothem * math.tan(math.pi / n_sides)


def regular_poly_side_length_to_apothem(n_sides, side_length):
    return side_length / (2 * math.tan(math.pi / n_sides))


def _rot(v, angle):
    c, s = math.cos(angle), math.sin(angle)
    return (c * v[0] - s * v[1], s * v[0] + c * v[1])


def compute_regular_poly_verts(n_sides, side_length):
    """geom.py:35-46 — first vertex points straight up (+y), CCW order."""
    radius = regular_poly_circumrad(n_sides, side_length)
    step = 2 * math.pi / n_sides
    return [_rot((0.0, radius), i * step) for i in range(n_sides)]


def compute_star_verts(n_points, out_radius, in_radius):
    """geom.py:49-63 — alternating outer/inner vertices, starting with an
    outer vertex pointing up."""
    verts = []
    for i in range(n_points):
        verts.append(_rot((0.0, out_radius), i * 2 * math.pi / n_points))
        verts.append(_rot((0.0, in_radius), (2 * i + 1) * math.pi / n_points))
    return verts


def rect_verts(w, h):
    """geom.py:101-108 — CCW from top right."""
    return [(w / 2, h / 2), (-w / 2, h / 2), (-w / 2, -h / 2), (w / 2, -h / 2)]


# ---------------------------------------------------------------------------
# Chipmunk moment formulas (cpMomentForPoly / cpMomentForCircle semantics,
# as called from entities.py:243,314,637,656,690)
# ---------------------------------------------------------------------------

def moment_for_circle(mass, inner_rad, outer_rad, offset=(0.0, 0.0)):
    return mass * (0.5 * (inner_rad ** 2 + outer_rad ** 2)
                   + offset[0] ** 2 + offset[1] ** 2)


def moment_for_poly(mass, verts, offset=(0.0, 0.0)):
    """Second polar moment of a polygon about the body origin, matching
    Chipmunk's cpMomentForPoly formula (valid for any simple polygon loop;
    the reference even calls it on the concatenated two-box finger loop,
    entities.py:313-315, so we reproduce the same formula rather than a
    "fixed" one)."""
    vs = [(v[0] + offset[0], v[1] + offset[1]) for v in verts]
    sum1 = 0.0
    sum2 = 0.0
    n = len(vs)
    for i in range(n):
        x1, y1 = vs[i]
        x2, y2 = vs[(i + 1) % n]
        a = x2 * y1 - y2 * x1          # cross(v2, v1)
        b = (x1 * x1 + y1 * y1) + (x1 * x2 + y1 * y2) + (x2 * x2 + y2 * y2)
        sum1 += a * b
        sum2 += a
    return (mass * sum1) / (6.0 * sum2)


# ---------------------------------------------------------------------------
# Block collision geometry table
# ---------------------------------------------------------------------------

def _padded(verts):
    """Pad a CCW vertex list to NV rows by repeating the final vertex.

    Repeating (rather than zero-filling) keeps every row a valid point of
    the convex hull, so vectorised support functions can run over all NV
    rows without masking."""
    out = np.zeros((NV, 2), dtype=np.float64)
    for i in range(NV):
        out[i] = verts[min(i, len(verts) - 1)]
    return out


def _star_decomposition(out_rad, in_rad):
    """Exact convex decomposition of the 5-point star polyline: the inner
    pentagon core plus five tip triangles.  The reference computes an
    equivalent decomposition at runtime with pymunk.autogeometry
    (entities.py:646-667); ours is precomputed and static."""
    verts = compute_star_verts(5, out_rad, in_rad)
    outer = verts[0::2]
    inner = verts[1::2]
    parts = [inner]  # pentagon core (CCW since source loop is CCW)
    for i in range(5):
        prev_inner = inner[i - 1]  # inner vertex before outer tip i
        tip = outer[i]
        next_inner = inner[i]
        parts.append([prev_inner, tip, next_inner])
    return parts


def build_block_geometry():
    """Build the (N_SHAPE_TYPES, KSUB, NV, 2) collision table for the fixed
    block size SHAPE_RAD, plus per-subshape radius/count/active-mask tables
    and per-type moments (mass = SHAPE_MASS).

    Sub-shape convention: nverts == 1 means "circle" (a point with a large
    radius) — the same unification Chipmunk uses internally.
    """
    size = C.SHAPE_RAD
    verts_tab = np.zeros((N_SHAPE_TYPES, KSUB, NV, 2), dtype=np.float64)
    rad_tab = np.zeros((N_SHAPE_TYPES, KSUB), dtype=np.float64)
    nv_tab = np.ones((N_SHAPE_TYPES, KSUB), dtype=np.int32)
    act_tab = np.zeros((N_SHAPE_TYPES, KSUB), dtype=bool)
    moment_tab = np.zeros((N_SHAPE_TYPES,), dtype=np.float64)
    mass = C.SHAPE_MASS

    def set_poly(t, k, verts, radius=0.0):
        verts_tab[t, k] = _padded(verts)
        rad_tab[t, k] = radius
        nv_tab[t, k] = len(verts)
        act_tab[t, k] = True

    # SQUARE: Poly.create_box side sqrt(pi)*size, bevel 0.01*side
    # (entities.py:620-634).
    side = math.sqrt(math.pi) * size
    bevel = 0.01 * side
    # Chipmunk's create_box insets nothing; the box polygon spans the full
    # side and the radius bevels outward.
    sq_verts = rect_verts(side, side)
    set_poly(C.ShapeType.SQUARE, 0, sq_verts, radius=bevel)
    moment_tab[C.ShapeType.SQUARE] = moment_for_poly(mass, sq_verts)

    # CIRCLE (entities.py:636-644): 1-vertex "poly" with radius size.
    set_poly(C.ShapeType.CIRCLE, 0, [(0.0, 0.0)], radius=size)
    moment_tab[C.ShapeType.CIRCLE] = moment_for_circle(mass, 0, size)

    # STAR (entities.py:646-667): out 1.3*size, in 0.65*size, 6 convex parts.
    out_rad = 1.3 * size
    in_rad = 0.5 * out_rad
    for k, part in enumerate(_star_decomposition(out_rad, in_rad)):
        set_poly(C.ShapeType.STAR, k, part)
    # Moment uses the convex hull of the star (= pentagon of outer tips,
    # entities.py:655-656).
    hull = compute_star_verts(5, out_rad, in_rad)[0::2]
    moment_tab[C.ShapeType.STAR] = moment_for_poly(mass, hull)

    # Regular polygons (entities.py:669-697).
    for t, (n_sides, factor) in (
            (C.ShapeType.TRIANGLE, (3, 0.8)),
            (C.ShapeType.PENTAGON, (5, 1.0)),
            (C.ShapeType.HEXAGON, (6, 1.0)),
            (C.ShapeType.OCTAGON, (8, 1.0))):
        side_len = factor * regular_poly_circ_rad_to_side_length(n_sides, size)
        pv = compute_regular_poly_verts(n_sides, side_len)
        set_poly(t, 0, pv)
        moment_tab[t] = moment_for_poly(mass, pv)

    return (verts_tab.astype(np.float32), rad_tab.astype(np.float32),
            nv_tab, act_tab, moment_tab.astype(np.float32))


(BLOCK_VERTS, BLOCK_SUB_RADIUS, BLOCK_SUB_NV, BLOCK_SUB_ACTIVE,
 BLOCK_MOMENT) = build_block_geometry()

# Bounding radius per shape type (for broadphase culling).
BLOCK_BOUND_RADIUS = np.zeros((N_SHAPE_TYPES,), dtype=np.float32)
for _t in range(N_SHAPE_TYPES):
    r = 0.0
    for _k in range(KSUB):
        if BLOCK_SUB_ACTIVE[_t, _k]:
            vr = np.linalg.norm(BLOCK_VERTS[_t, _k], axis=-1).max()
            r = max(r, vr + BLOCK_SUB_RADIUS[_t, _k])
    BLOCK_BOUND_RADIUS[_t] = r


# ---------------------------------------------------------------------------
# Robot geometry
# ---------------------------------------------------------------------------

def make_finger_vertices(upper_arm_len, forearm_len, thickness, side_sign):
    """entities.py:193-214 — two rotated boxes forming one finger, in the
    finger body's local frame (origin at the root of the upper arm)."""
    up_shift = upper_arm_len / 2
    upper = rect_verts(thickness, upper_arm_len)
    fore = rect_verts(thickness, forearm_len)
    upper_start = (side_sign * thickness / 2, upper_arm_len / 2)
    fore_off_unrot = (-side_sign * thickness / 2, forearm_len / 2)
    rot_angle = side_sign * math.pi / 8
    fo = _rot(fore_off_unrot, rot_angle)
    fore_trans = (upper_start[0] + fo[0], upper_start[1] + fo[1] + up_shift)
    fore_final = [
        (_rot(v, rot_angle)[0] + fore_trans[0],
         _rot(v, rot_angle)[1] + fore_trans[1]) for v in fore]
    upper_final = [(v[0], v[1] + up_shift) for v in upper]
    return upper_final, fore_final


def build_robot_geometry():
    """Collision geometry + mass properties for the robot's 3 dynamic bodies
    (main circle body + 2 finger bodies) and the 2 eye bodies."""
    out = {}
    out['body_radius'] = C.ROBOT_RAD
    out['body_mass'] = C.ROBOT_MASS
    out['body_moment'] = moment_for_circle(C.ROBOT_MASS, 0, C.ROBOT_RAD)

    finger_polys = []      # (2 sides, 2 sub-boxes, 4, 2)
    for side_sign in (-1, 1):
        upper, fore = make_finger_vertices(
            C.FINGER_UPPER_LENGTH, C.FINGER_LOWER_LENGTH,
            C.FINGER_THICKNESS, side_sign)
        finger_polys.append([upper, fore])
    out['finger_polys'] = np.array(finger_polys, dtype=np.float32)
    out['finger_mass'] = C.FINGER_MASS
    # moment over concatenated vertex loop (entities.py:313-315)
    upper_l, fore_l = finger_polys[0]
    out['finger_moment'] = moment_for_poly(
        C.FINGER_MASS, list(upper_l) + list(fore_l))
    out['finger_rel_pos'] = np.array(
        [(-C.FINGER_REL_POS_X, C.FINGER_REL_POS_Y),
         (C.FINGER_REL_POS_X, C.FINGER_REL_POS_Y)], dtype=np.float32)
    # initial finger angle deltas (entities.py:307-322): left finger starts
    # at +outer limit, right at -outer limit.
    out['finger_init_delta'] = np.array(
        [C.FINGER_ROT_LIMIT_OUTER, -C.FINGER_ROT_LIMIT_OUTER],
        dtype=np.float32)
    # rotary limits per side (lower, upper) (entities.py:307-312)
    out['finger_rot_limits'] = np.array(
        [(-C.FINGER_ROT_LIMIT_INNER, C.FINGER_ROT_LIMIT_OUTER),
         (-C.FINGER_ROT_LIMIT_OUTER, C.FINGER_ROT_LIMIT_INNER)],
        dtype=np.float32)

    out['eye_mass'] = C.EYE_MASS
    out['eye_moment'] = moment_for_circle(C.EYE_MASS, 0, C.ROBOT_RAD)
    return out


ROBOT_GEOM = build_robot_geometry()

# Bounding radius of a finger sub-box from the finger body origin.
FINGER_BOUND_RADIUS = float(
    np.linalg.norm(ROBOT_GEOM['finger_polys'].reshape(-1, 2), axis=-1).max())


# ---------------------------------------------------------------------------
# Renderer geometry: "inner" (bright) polygon variants for block outlines
# (entities.py:713-757).  Same layout as the collision table.
# ---------------------------------------------------------------------------

def build_block_render_geometry():
    size = C.SHAPE_RAD
    lt = C.SHAPE_LINE_THICKNESS
    verts_tab = np.zeros((N_SHAPE_TYPES, KSUB, NV, 2), dtype=np.float64)
    rad_tab = np.zeros((N_SHAPE_TYPES, KSUB), dtype=np.float64)
    nv_tab = np.ones((N_SHAPE_TYPES, KSUB), dtype=np.int32)
    act_tab = np.zeros((N_SHAPE_TYPES, KSUB), dtype=bool)

    def set_poly(t, k, verts, radius=0.0):
        verts_tab[t, k] = _padded(verts)
        rad_tab[t, k] = radius
        nv_tab[t, k] = len(verts)
        act_tab[t, k] = True

    side = math.sqrt(math.pi) * size
    set_poly(C.ShapeType.SQUARE, 0, rect_verts(side - 2 * lt, side - 2 * lt))
    set_poly(C.ShapeType.CIRCLE, 0, [(0.0, 0.0)], radius=size - lt)
    out_rad = 1.3 * size
    in_rad = 0.5 * out_rad
    for k, part in enumerate(_star_decomposition(out_rad - lt, in_rad - lt)):
        set_poly(C.ShapeType.STAR, k, part)
    for t, (n_sides, factor) in (
            (C.ShapeType.TRIANGLE, (3, 0.8)),
            (C.ShapeType.PENTAGON, (5, 1.0)),
            (C.ShapeType.HEXAGON, (6, 1.0)),
            (C.ShapeType.OCTAGON, (8, 1.0))):
        side_len = factor * regular_poly_circ_rad_to_side_length(n_sides, size)
        apothem = regular_poly_side_length_to_apothem(n_sides, side_len)
        short_side = regular_poly_apothem_to_side_length(n_sides, apothem - lt)
        set_poly(t, 0, compute_regular_poly_verts(n_sides, short_side))
    return (verts_tab.astype(np.float32), rad_tab.astype(np.float32),
            nv_tab, act_tab)


(BLOCK_VERTS_INNER, BLOCK_SUB_RADIUS_INNER, BLOCK_SUB_NV_INNER,
 BLOCK_SUB_ACTIVE_INNER) = build_block_render_geometry()


def build_finger_render_geometry():
    """Inner (light) finger polys (entities.py:296-304): shrunk boxes,
    shifted up by the line thickness."""
    lt = C.ROBOT_LINE_THICKNESS
    polys = []
    for side_sign in (-1, 1):
        upper, fore = make_finger_vertices(
            C.FINGER_UPPER_LENGTH - lt * 2, C.FINGER_LOWER_LENGTH - lt * 2,
            C.FINGER_THICKNESS - lt * 2, side_sign)
        shifted = [[(x, y + lt) for x, y in box] for box in (upper, fore)]
        polys.append(shifted)
    return np.array(polys, dtype=np.float32)


FINGER_POLYS_INNER = build_finger_render_geometry()
