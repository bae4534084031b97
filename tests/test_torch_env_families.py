"""The six multi-block task families through magical_tpu_torch's
BatchedEnv against magical_tpu's on the CPU: one ID of each family, from a
converted JAX reset to the end of the episode (FixColour, MakeLine and
FindDupe; the wider families are in test_torch_env_families_wide.py)."""

import pytest

from _torch_port import slice_against_the_reference


@pytest.mark.parametrize('name,fidelity', [
    ('FixColour-Demo-LoRes4E-v0', 'hi'),
    ('MakeLine-Demo-v0', 'lo'),                   # raw {allo, ego} 384²
    ('FindDupe-TestShape-LoRes4A-v0', 'lo'),
])
def test_family_slice_matches_the_reference(name, fidelity):
    te, tc, info = slice_against_the_reference(name, fidelity)
    assert te.task.max_blocks == tc.state.block_active.shape[1]
    assert info['n_placement_failures'].shape == (2,)
