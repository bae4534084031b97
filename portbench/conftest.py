"""pytest settings of the benchmark's own tests (``portbench/tests``):
the ``cuda`` marker, for tests that need a CUDA card.  Whether there is a
card is decided by the ``cuda_card`` fixture, when a test runs."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA card; skips without one')


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card')
    return torch.device('cuda')
