"""MatchRegions's Test resets, magical_tpu_torch against magical_tpu, in
distribution (tests/test_torch_tasks_ks.py)."""

import pytest

from test_torch_tasks_ks import VARIANTS, check_reset_distributions


@pytest.mark.parametrize('variant', VARIANTS)
def test_reset_distributions_match(variant):
    check_reset_distributions('MatchRegions', variant)
