"""Global constants of the MAGICAL benchmark suite, for the PyTorch port.

A numpy copy of ``magical_tpu/constants.py``: importing that module runs
``magical_tpu/__init__.py``, which pulls in JAX, and this package must
import without it.  ``tests/test_torch_tables.py`` holds the two equal.

Every number here is part of the *behavioural spec* of the reference
implementation (qxcv/magical) and is cited back to it, but the code is
organised for a batched engine: everything is a plain float/int or a
numpy table that gets uploaded to the device as a constant table.

References:
  - physical constants:    magical/base_env.py:61-76
  - physics variables:     magical/base_env.py:49-57
  - action table:          magical/entities.py:148-190
  - colours & thicknesses: magical/style.py
"""

import colorsys
import enum
import math

import numpy as np

# ---------------------------------------------------------------------------
# Arena / entity scale constants (base_env.py:61-76)
# ---------------------------------------------------------------------------

ROBOT_RAD = 0.2
ROBOT_MASS = 1.0
SHAPE_RAD = ROBOT_RAD * 0.6  # 0.12
ARENA_BOUNDS_LRBT = (-1.0, 1.0, -1.0, 1.0)
ARENA_SIZE_MAX = max(ARENA_BOUNDS_LRBT)
RAND_GOAL_MIN_SIZE = 0.5
RAND_GOAL_MAX_SIZE = 0.8
RAND_GOAL_SIZE_RANGE = RAND_GOAL_MAX_SIZE - RAND_GOAL_MIN_SIZE
JITTER_PCT = 0.05
JITTER_POS_BOUND = ARENA_SIZE_MAX * JITTER_PCT / 2.0           # 0.025
JITTER_ROT_BOUND = JITTER_PCT * math.pi                         # 0.05*pi
JITTER_TARGET_BOUND = JITTER_PCT * RAND_GOAL_SIZE_RANGE / 2     # 0.0075

# ---------------------------------------------------------------------------
# Control / physics rates (benchmarks/__init__.py:401-404, base_env.py:236-243)
# ---------------------------------------------------------------------------

FPS = 8
PHYS_STEPS = 10           # physics substeps per control step (hardcoded)
PHYS_ITER = 10            # impulse-solver iterations per substep
DT = (1.0 / FPS) / PHYS_STEPS   # 1/80 s

# Chipmunk space defaults used by the reference (base_env.py:194-196 sets
# only collision_slop; everything else is the Chipmunk 7 default).
COLLISION_SLOP = 0.01
# Chipmunk default collision bias: (1 - 0.1) ** 60 interpreted as the
# fraction of overlap remaining after 1 second of correction.
COLLISION_BIAS = (1.0 - 0.1) ** 60.0
# Default joint error bias (same formula family).
DEFAULT_ERROR_BIAS = (1.0 - 0.1) ** 60.0


def bias_coef(error_bias: float, dt: float) -> float:
    """Chipmunk's bias_coef: fraction of positional error corrected in dt."""
    return 1.0 - error_bias ** dt


# ---------------------------------------------------------------------------
# Physics variables: defaults and Dynamics-variant randomisation ranges
# (base_env.py:49-57). Order matters for RNG parity: sampling happens in
# declaration order via PhysicsVariables.sample (phys_vars.py:70-83).
# ---------------------------------------------------------------------------

PHYS_VAR_DEFAULTS = np.array([3.0, 1.0, 4.0, 1.5, 0.1], dtype=np.float32)
PHYS_VAR_LO = np.array([2.2, 0.7, 2.5, 1.0, 0.07], dtype=np.float32)
PHYS_VAR_HI = np.array([3.5, 1.5, 4.5, 1.8, 0.15], dtype=np.float32)
# Index names into the vector above:
PV_ROBOT_POS_FORCE = 0     # robot_pos_joint_max_force
PV_ROBOT_ROT_FORCE = 1     # robot_rot_joint_max_force
PV_FINGER_FORCE = 2        # robot_finger_max_force
PV_SHAPE_TRANS_FORCE = 3   # shape_trans_joint_max_force
PV_SHAPE_ROT_FORCE = 4     # shape_rot_joint_max_force
N_PHYS_VARS = 5

# ---------------------------------------------------------------------------
# Robot control constants (entities.py:217-479)
# ---------------------------------------------------------------------------

FINGER_ROT_LIMIT_OUTER = math.pi / 8
FINGER_ROT_LIMIT_INNER = 0.0
ROBOT_FWD_SPEED = 4.0 * ROBOT_RAD        # UP target speed (entities.py:443)
ROBOT_REV_SPEED = -3.0 * ROBOT_RAD       # DOWN target speed (entities.py:445)
ROBOT_TURN_ANGLE = 1.5                   # LEFT/RIGHT rel turn (entities.py:449-451)
ROBOT_GEAR_MAX_BIAS = 2.5                # rot control joint (entities.py:261)
EYE_SPRING_STIFFNESS = 0.1               # googly eyes (entities.py:273)
EYE_SPRING_DAMPING = 3e-3
FINGER_MASS = ROBOT_MASS / 8
EYE_MASS = ROBOT_MASS / 10
FINGER_THICKNESS = 0.25 * ROBOT_RAD
FINGER_UPPER_LENGTH = 1.1 * ROBOT_RAD
FINGER_LOWER_LENGTH = 0.7 * ROBOT_RAD
FINGER_REL_POS_X = 0.45 * ROBOT_RAD      # +- for right/left (entities.py:324)
FINGER_REL_POS_Y = 0.1 * ROBOT_RAD

# Frictions (entities.py:361,372,699-701,516)
ROBOT_BODY_FRICTION = 0.5
FINGER_FRICTION = 5.0
SHAPE_FRICTION = 0.5
WALL_FRICTION = 0.8
SHAPE_MASS = 0.5

# ---------------------------------------------------------------------------
# Discrete action table (entities.py:148-190): 18 actions = cartesian product
# of {none,up,down} x {none,left,right} x {open,close}, flattened in the
# reference's canonical order.
# ---------------------------------------------------------------------------

N_ACTIONS = 18

# Per-action decomposition, exactly mirroring ACTION_NUMS_FLAGS_NAMES
# (entities.py:162-182).  Columns: up, down, left, right, open, close.
_UD = [(0, 0), (1, 0), (0, 1)]           # none, up, down
_LR = [(0, 0), (1, 0), (0, 1)]           # none, left, right
_OC = [(1, 0), (0, 1)]                   # open first 9 ids, close last 9

ACTION_TABLE = np.zeros((N_ACTIONS, 6), dtype=np.int32)
_names = []
for oc_i, (op, cl) in enumerate(_OC):
    for lr_i, (lf, rt) in enumerate(_LR):
        for ud_i, (up, dn) in enumerate(_UD):
            aid = oc_i * 9 + lr_i * 3 + ud_i
            ACTION_TABLE[aid] = (up, dn, lf, rt, op, cl)
            _names.append(
                ('Up' if up else '') + ('Down' if dn else '') +
                ('Left' if lf else '') + ('Right' if rt else '') +
                ('Open' if op else 'Close'))
ACTION_NAMES = tuple(_names)
del _names

# Pre-derived per-action control targets, looked up by the control step:
#   target_speed (entities.py:439-447), rel_turn_angle, target_finger_angle
_ts = np.zeros(N_ACTIONS, dtype=np.float32)
_ta = np.zeros(N_ACTIONS, dtype=np.float32)
_tf = np.zeros(N_ACTIONS, dtype=np.float32)
for aid in range(N_ACTIONS):
    up, dn, lf, rt, op, cl = ACTION_TABLE[aid]
    speed = 0.0
    if up:
        speed += ROBOT_FWD_SPEED
    if dn:
        speed += ROBOT_REV_SPEED
    if up and dn:
        speed = 0.0
    _ts[aid] = speed
    _ta[aid] = ROBOT_TURN_ANGLE * (lf - rt)
    _tf[aid] = FINGER_ROT_LIMIT_OUTER if op else -FINGER_ROT_LIMIT_INNER
ACTION_TARGET_SPEED = _ts
ACTION_TURN_ANGLE = _ta
ACTION_FINGER_ANGLE = _tf
del _ts, _ta, _tf

# ---------------------------------------------------------------------------
# Shape & colour enumerations (entities.py:545-581). Integer codes are the
# on-device representation; the string values match the reference enums.
# ---------------------------------------------------------------------------


class ShapeType(enum.IntEnum):
    TRIANGLE = 0
    SQUARE = 1
    PENTAGON = 2
    HEXAGON = 3
    OCTAGON = 4
    CIRCLE = 5
    STAR = 6


class ShapeColour(enum.IntEnum):
    RED = 0
    GREEN = 1
    BLUE = 2
    YELLOW = 3


SHAPE_TYPE_NAMES = ('triangle', 'square', 'pentagon', 'hexagon', 'octagon',
                    'circle', 'star')
SHAPE_COLOUR_NAMES = ('red', 'green', 'blue', 'yellow')

# Random-generation subsets (entities.py:568-581); order matters for RNG
# parity with rng.choice over these arrays.
RAND_SHAPE_TYPES = (ShapeType.SQUARE, ShapeType.PENTAGON, ShapeType.STAR,
                    ShapeType.CIRCLE)
RAND_SHAPE_COLOURS = (ShapeColour.RED, ShapeColour.GREEN, ShapeColour.BLUE,
                      ShapeColour.YELLOW)

# ---------------------------------------------------------------------------
# Colours (style.py). We reproduce the exact palette: Berkeley brand colours
# lightened in HLS space.
# ---------------------------------------------------------------------------

GOAL_LINE_THICKNESS = 0.01
SHAPE_LINE_THICKNESS = 0.015
ROBOT_LINE_THICKNESS = 0.01
ARENA_ZOOM_OUT = 1.02


def _rgb(r, g, b):
    return (r / 255.0, g / 255.0, b / 255.0)


def darken_rgb(rgb):
    """style.py:10-14 — darker version of a base colour (HLS l * 0.9)."""
    h, l, s = colorsys.rgb_to_hls(*rgb)
    return colorsys.hls_to_rgb(h, max(0, l * 0.9), s)


def lighten_rgb(rgb, times=1):
    """style.py:17-22 — lighter version of a base colour."""
    h, l, s = colorsys.rgb_to_hls(*rgb)
    mult = 1.4 ** times
    return colorsys.hls_to_rgb(h, 1 - (1 - l) / mult, s)


COLOURS_RGB = {
    'blue': lighten_rgb(_rgb(0x3B, 0x7E, 0xA1), 1.7),
    'yellow': lighten_rgb(_rgb(0xFD, 0xB5, 0x15), 1.7),
    'red': lighten_rgb(_rgb(0xEE, 0x1F, 0x60), 1.7),
    'green': lighten_rgb(_rgb(0x85, 0x94, 0x38), 1.7),
    'grey': _rgb(162, 163, 175),
    'brown': _rgb(224, 171, 118),
}

# (4, 3) float tables indexed by ShapeColour code, plus derived variants used
# by the renderer (entities.py:750-753, 807-817).
BLOCK_COLOURS = np.array(
    [COLOURS_RGB[SHAPE_COLOUR_NAMES[c]] for c in range(4)], dtype=np.float32)
BLOCK_COLOURS_DARK = np.array(
    [darken_rgb(COLOURS_RGB[SHAPE_COLOUR_NAMES[c]]) for c in range(4)],
    dtype=np.float32)
GOAL_COLOURS_LIGHT = np.array(
    [lighten_rgb(COLOURS_RGB[SHAPE_COLOUR_NAMES[c]], times=2)
     for c in range(4)], dtype=np.float32)

ROBOT_COLOUR = np.array(COLOURS_RGB['grey'], dtype=np.float32)
ROBOT_COLOUR_DARK = np.array(darken_rgb(COLOURS_RGB['grey']), dtype=np.float32)
ROBOT_COLOUR_LIGHT = np.array(
    lighten_rgb(COLOURS_RGB['grey'], 4), dtype=np.float32)
BACKGROUND_COLOUR = np.array(
    lighten_rgb(COLOURS_RGB['grey'], 4), dtype=np.float32)  # base_env.py:186
ARENA_GREY = np.array(COLOURS_RGB['grey'], dtype=np.float32)

# ---------------------------------------------------------------------------
# Rendering resolutions (benchmarks/__init__.py:23,242-274)
# ---------------------------------------------------------------------------

DEFAULT_RES = (384, 384)
LORES_RES = (96, 96)
FRAME_STACK_DEPTH = 4
