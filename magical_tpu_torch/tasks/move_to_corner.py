"""MoveToCorner: push the block to the top-left corner.

The PyTorch counterpart of ``magical_tpu/tasks/move_to_corner.py``
(reference: magical/benchmarks/move_to_corner.py).  Only the variants
without layout randomisation reset here: jittered poses need the SAT
placement sampler of ``tasks/randomize.py``, which is not ported yet.
"""

import math

import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch.core.state import make_initial_state
from magical_tpu_torch.tasks import base as B

MAX_BLOCKS = 1
MAX_GOALS = 1          # unused (kept >=1 for static-shape friendliness)
EP_LEN = 80

ROBOT_POSE = ((0.4, 0.0), 0.55 * math.pi)
BLOCK_POSE = ((0.1, -0.65), 0.13 * math.pi)

VARIANTS = ('Demo', 'TestJitter', 'TestColour', 'TestShape', 'TestDynamics',
            'TestAll')
VARIANT_FLAGS = {
    'Demo': B.Flags(),
    'TestJitter': B.Flags(layout_minor=True),
    'TestColour': B.Flags(colour=True),
    'TestShape': B.Flags(shape=True),
    'TestDynamics': B.Flags(dynamics=True),
    'TestAll': B.Flags(colour=True, shape=True, layout_minor=True,
                       dynamics=True),
}


def reset(generator: torch.Generator, batch: int, flags: B.Flags, device):
    """Reset `batch` envs.  Draws from `generator` only where the variant
    randomises something."""
    if flags.any_layout:
        raise NotImplementedError(
            'MoveToCorner layout randomisation needs tasks/randomize.py '
            '(ROADMAP.md, "Modules to port", item 1)')
    state = make_initial_state(batch, MAX_BLOCKS, MAX_GOALS, device)
    state = state.replace(phys=B.sample_phys(generator, batch, flags,
                                             device))

    colour = torch.full((batch,), int(C.ShapeColour.RED), dtype=torch.int32,
                        device=device)
    shape = torch.full((batch,), int(C.ShapeType.SQUARE), dtype=torch.int32,
                       device=device)
    if flags.colour:
        colour = B.choice(generator, C.RAND_SHAPE_COLOURS, batch, device)
    if flags.shape:
        shape = B.choice(generator, C.RAND_SHAPE_TYPES, batch, device)

    def per_env(x):
        t = torch.tensor(x, dtype=torch.float32, device=device)
        return t.expand((batch,) + tuple(t.shape))

    state = B.set_blocks(state, shape[:, None], colour[:, None],
                         per_env(BLOCK_POSE[0])[:, None],
                         per_env(BLOCK_POSE[1])[:, None],
                         torch.ones((batch, 1), dtype=torch.bool,
                                    device=device))
    return B.finalize_robot(state, per_env(ROBOT_POSE[0]),
                            per_env(ROBOT_POSE[1]))


def score(state):
    """move_to_corner.py:66-75 — linear ramp on block distance to (-1, 1)."""
    p = state.pos[..., 5, :]
    d = torch.tensor([-1.0, 1.0], device=p.device) - p
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    succeed = math.sqrt(2) / 2
    furthest = math.sqrt(2)
    return torch.clamp((furthest - dist) / (furthest - succeed), 0.0, 1.0)


TASK = B.TaskDef(
    name='MoveToCorner', max_blocks=MAX_BLOCKS, max_goals=MAX_GOALS,
    ep_len=EP_LEN, variants=VARIANTS, variant_flags=VARIANT_FLAGS,
    reset_fn=reset, score_fn=score,
    default_shapes=(int(C.ShapeType.SQUARE),), default_active=(True,))
