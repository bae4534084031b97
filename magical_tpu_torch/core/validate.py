"""Runtime state validation: NaN and envelope guards over the physics state.

The PyTorch counterpart of ``magical_tpu/core/validate.py``.  The
reference's closest analogues are its runtime asserts (score range,
name-grammar round-trip, PlacementError); the batched engine adds guards
that the physics state stays finite and inside a generous envelope, and
host-side validators with a readable report for tests and tools.
"""

from __future__ import annotations

import torch

from magical_tpu_torch.core.state import N_ROBOT_BODIES, EnvState

# generous dynamics envelope: robot max speed 0.8; solver-impulse spikes
# during deep contact resolution stay far below these
MAX_SPEED = 50.0
MAX_OMEGA = 200.0
POS_BOUND = 60.0          # arena is [-1,1]


def state_finite(state: EnvState) -> torch.Tensor:
    """A 0-d bool tensor on the state's device: True iff every env's state
    is finite and within the envelope.  Reading it on the host waits for
    the device.

    The position bound holds for the bodies in play, the robot's and the
    active blocks'.  Inactive blocks are parked at (50 + 4 b, 50) for slot
    b, beyond the bound from b = 3 on; the JAX package bounds them too, so
    that its check fails on every reset that parks a block there (any
    ClusterColour, ClusterShape or MatchRegions reset)."""
    ok = torch.isfinite(state.pos).all() & torch.isfinite(state.vel).all() \
        & torch.isfinite(state.angle).all() \
        & torch.isfinite(state.omega).all()
    ok &= (torch.abs(state.vel) < MAX_SPEED).all()
    ok &= (torch.abs(state.omega) < MAX_OMEGA).all()
    in_play = torch.cat([torch.ones_like(state.block_active[:, :1]).expand(
        -1, N_ROBOT_BODIES), state.block_active], 1)
    inside = (torch.abs(state.pos) < POS_BOUND).all(-1)
    ok &= (inside | ~in_play).all()
    return ok


def checked_step(step_fn):
    """Wrap a step function so that it raises once the state it returns
    leaves :func:`state_finite` (the counterpart of the JAX package's
    checkify wrapper; one host-device synchronisation per call)."""

    def checked(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        state = out[0].state if hasattr(out[0], 'state') else out[0]
        if not bool(state_finite(state)):
            raise AssertionError('physics state became invalid '
                                 '(NaN/overflow)')
        return out

    return checked


def assert_valid_host(state: EnvState, where=''):
    """Host-side validator with a readable report (for tests/tools)."""
    pos = state.pos.detach().cpu()
    vel = state.vel.detach().cpu()
    problems = []
    if not bool(torch.isfinite(pos).all()):
        problems.append('non-finite positions')
    if not bool(torch.isfinite(vel).all()):
        problems.append('non-finite velocities')
    vmax = float(vel.abs().max()) if vel.numel() else 0.0
    if vmax >= MAX_SPEED:
        problems.append(f'velocity blow-up (max {vmax:.1f})')
    if problems:
        raise AssertionError(f'invalid state {where}: ' + '; '.join(problems))


def assert_placements_ok(state: EnvState, where=''):
    """Host-side: no reset placement fell back to a colliding pose (the
    reference's PlacementError): resets count failed placements in
    ``EnvState.place_fail`` and steps report them in
    ``info['n_placement_failures']``."""
    fails = state.place_fail.detach().cpu()
    if bool(fails.any()):
        n_envs = int((fails > 0).sum()) if fails.dim() else 1
        raise AssertionError(
            f'placement failure {where}: {int(fails.sum())} entities in '
            f'{n_envs} env(s) kept a possibly-colliding pose')
