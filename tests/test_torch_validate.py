"""magical_tpu_torch.core.validate against magical_tpu.core.validate: the
envelope constants, state_finite on finite and on poisoned states, and the
host validators' verdicts and reports."""

import jax
import numpy as np
import pytest
import torch

from magical_tpu.core import validate as JV
from magical_tpu_torch.core import validate as TV

from _torch_port import FAMILIES, jax_resets, jax_to_torch


def test_envelope_constants_match():
    for name in ('MAX_SPEED', 'MAX_OMEGA', 'POS_BOUND'):
        assert getattr(TV, name) == getattr(JV, name)


def _poisoned(js, field, index, value):
    x = np.array(getattr(js, field))
    x[index] = value
    return js.replace(**{field: jax.numpy.asarray(x)})


# (field, value): non-finite values and values just outside the envelope,
# and the largest values inside it
POISONS = [('pos', np.nan), ('pos', np.inf), ('pos', 60.0), ('pos', -60.5),
           ('pos', 59.9), ('vel', -np.inf), ('vel', 50.0), ('vel', 49.9),
           ('angle', np.nan), ('angle', 1e6), ('omega', 200.0),
           ('omega', -199.0), ('omega', np.nan)]


@pytest.mark.parametrize('task,variant', [('MoveToCorner', 'TestAll'),
                                          ('FindDupe', 'Demo')])
@pytest.mark.parametrize('body', ['robot', 'block'])
def test_state_finite_matches_the_reference(task, variant, body):
    """States with every block in play, poisoned in the robot's body or in
    the last block."""
    js = jax_resets(task, variant, 4)
    assert np.asarray(js.block_active).all()
    assert bool(TV.state_finite(jax_to_torch(js))) is True
    assert bool(JV.state_finite(js)) is True
    n_bad = 0
    for field, value in POISONS:
        shape = np.shape(getattr(js, field))
        index = (2, 0 if body == 'robot' else shape[1] - 1) \
            + (0,) * (len(shape) - 2)
        bad = _poisoned(js, field, index, value)
        want = bool(JV.state_finite(bad))
        got = TV.state_finite(jax_to_torch(bad))
        assert got.dtype == torch.bool and got.dim() == 0
        assert bool(got) is want, (field, value)
        n_bad += not want
    assert n_bad == 9


@pytest.mark.parametrize('task', ['MatchRegions', 'ClusterColour'])
def test_parked_blocks_are_inside_the_envelope(task):
    """Inactive blocks are parked at (50 + 4 b, 50); the reference bounds
    them by POS_BOUND = 60 too and so refuses every Demo reset of these
    families.  The port bounds the bodies in play only."""
    js = jax_resets(task, 'Demo', 4)
    active = np.asarray(js.block_active)
    assert not active.all()
    assert bool(JV.state_finite(js)) is False
    ts = jax_to_torch(js)
    assert bool(TV.state_finite(ts)) is True
    # an active block past the bound, or a parked one that is not finite
    b = int(np.flatnonzero(active[1])[-1])
    ts.pos[1, 5 + b, 1] = 60.0
    assert bool(TV.state_finite(ts)) is False
    ts = jax_to_torch(js)
    ts.pos[1, 5 + int(np.flatnonzero(~active[1])[0]), 0] = float('inf')
    assert bool(TV.state_finite(ts)) is False


@pytest.mark.parametrize('field,value', [('pos', np.nan), ('vel', np.inf),
                                         ('vel', -75.0), ('vel', 3.0)])
def test_host_validator_matches_the_reference(field, value):
    js = _poisoned(jax_resets(FAMILIES[0], 'Demo', 2), field, (1, 3, 0),
                   value)
    ts = jax_to_torch(js)
    try:
        JV.assert_valid_host(js, 'here')
        want = None
    except AssertionError as e:
        want = str(e)
    if want is None:
        TV.assert_valid_host(ts, 'here')
    else:
        with pytest.raises(AssertionError) as got:
            TV.assert_valid_host(ts, 'here')
        assert str(got.value) == want


def test_placement_check_and_checked_step():
    js = jax_resets('FindDupe', 'Demo', 2)
    ts = jax_to_torch(js)
    TV.assert_placements_ok(ts)
    fails = np.array([0, 2], np.int32)
    bad = js.replace(place_fail=jax.numpy.asarray(fails))
    with pytest.raises(AssertionError) as want:
        JV.assert_placements_ok(bad, 'at reset')
    with pytest.raises(AssertionError) as got:
        TV.assert_placements_ok(jax_to_torch(bad), 'at reset')
    assert str(got.value) == str(want.value)

    def step(state):
        return state, 0.0

    checked = TV.checked_step(step)
    assert checked(ts)[0] is ts
    ts.omega[0, 0] = float('nan')
    with pytest.raises(AssertionError, match='invalid'):
        checked(ts)
