"""Every variant of mt3_tpu_torch.tools.perf_experiments gives the greedy
tokens of tools/perf_experiments.py at tiny width, identical, both tools
run through their main() in float32 from the same parameters and frames
(tests/test_torch_measure_perf_experiments.run_both says how).
"""

import pytest
import torch

from tests.test_torch_measure_perf_experiments import (  # noqa: F401
    BATCH, VARIANTS, check_tokens, jax_tool, run_both)

torch.set_num_threads(2)


@pytest.mark.parametrize('variant', VARIANTS)
def test_greedy_tokens_match_the_jax_tool(jax_tool, monkeypatch, variant):
  want, got = run_both(jax_tool, monkeypatch, [
      '--variant', variant, '--batch', str(BATCH), '--iters', '1',
      '--steps_per_iter', '4'])
  check_tokens(want, got)
