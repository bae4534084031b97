"""ClusterColour-TestCountPlus's resets, magical_tpu_torch against
magical_tpu, in distribution (tests/test_torch_tasks_ks.py)."""

import pytest

from test_torch_tasks_ks import check_reset_distributions


@pytest.mark.parametrize('variant', ['TestCountPlus'])
def test_reset_distributions_match(variant):
    check_reset_distributions('ClusterColour', variant)
