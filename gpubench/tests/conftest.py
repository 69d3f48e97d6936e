"""Tests of the benchmark itself.  CPU tests run anywhere; tests marked
`card` need a CUDA device and skip without one (decided in the `card`
fixture, never at import)."""

import pytest


def pytest_configure(config):
  config.addinivalue_line(
      'markers', 'card: needs a CUDA device; skips without one')


@pytest.fixture
def card():
  import torch
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda', 0)
