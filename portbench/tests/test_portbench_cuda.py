"""Every cell of BENCHMARK.json on the card, one whole episode each:
correct, and the control not.  Marked ``cuda``; skips without a card."""

import math

import pytest

from portbench.harness import bench, check, spec

WORKLOADS = [w['name'] for w in spec.benchmark()['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('workload', WORKLOADS)
def test_cell_is_correct_and_its_control_is_not(workload, cuda_card):
    cell = spec.cell(workload)
    r = bench.run_cell(cell, 2 ** 31 + 4242, math.inf, False,
                       device=cuda_card, control=True, episodes=1)
    assert r['correct'], r['checks']
    assert not check.verdict(r['control'], cell.traffic['limits'],
                             list(r['checks']))
