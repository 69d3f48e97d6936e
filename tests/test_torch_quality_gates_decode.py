"""The port's quality gates against tools/quality_gates.py, on the CPU:
the rows that change the decode rather than the caches (stacked carry,
beam search, the mean-pooled 1-K/V-head conversion), on the model and clips
of tests/test_torch_quality_gates.py, at the same tolerances."""

import pytest

from tests.test_torch_quality_gates import check_row, jax_gates, setup  # noqa: F401  (fixtures)


@pytest.mark.parametrize('name', ['stacked', 'beam4', 'gqa1'])
def test_gate_row_matches_jax(setup, jax_gates, name):  # noqa: F811
  check_row(setup, jax_gates, name)
