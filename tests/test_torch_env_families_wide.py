"""MatchRegions, ClusterColour and ClusterShape through magical_tpu_torch's
BatchedEnv against magical_tpu's on the CPU, from a converted JAX reset to
the end of the episode (see test_torch_env_families.py)."""

import pytest

from _torch_port import slice_against_the_reference


@pytest.mark.parametrize('name,fidelity', [
    ('MatchRegions-Demo-LoResStack-v0', 'lo'),
    ('ClusterColour-Demo-LoRes4E-v0', 'lo'),
    ('ClusterShape-TestColour-LoResCHW4E-v0', 'lo'),
])
def test_family_slice_matches_the_reference(name, fidelity):
    te, tc, info = slice_against_the_reference(name, fidelity)
    assert te.task.max_blocks == tc.state.block_active.shape[1]
    assert info['n_placement_failures'].shape == (2,)
