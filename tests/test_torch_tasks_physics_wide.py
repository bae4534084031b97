"""magical_tpu_torch's plain control step against magical_tpu's XLA
reference at 8 and 10 blocks (MatchRegions, ClusterColour, ClusterShape),
from converted JAX Demo and TestAll states (tests/test_torch_tasks_physics.py
has the narrower families and the method)."""

import pytest

from test_torch_tasks_physics import check_physics


@pytest.mark.parametrize('task', ['MatchRegions', 'ClusterColour',
                                  'ClusterShape'])
@pytest.mark.parametrize('variant', ['Demo', 'TestAll'])
def test_control_step_matches_the_reference(task, variant):
    check_physics(task, variant)
