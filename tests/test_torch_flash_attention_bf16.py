"""Kernel C's plain version against the stock TPU kernel, bfloat16 inputs.

The comparison of test_torch_flash_attention.py (see its docstring for the
tolerances) with bfloat16 q, k, v and dO, the training dtype.
"""

import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_flash_attention import (BF16_TOL, CASES, _inputs,
                                              _plain, _stock, tile_rel_err)

torch.set_num_threads(2)


def _round_bf16(x):
  return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize('lengths,causal,head_dim', CASES)
def test_plain_matches_stock_kernel_bfloat16(lengths, causal, head_dim):
  lq, lk = lengths
  inputs = _inputs(lq, lk, head_dim, seed=lq + lk + head_dim + causal)
  want = _stock(*inputs, causal, jnp.bfloat16)
  got = _plain(*inputs, causal, torch.bfloat16)
  truth = _plain(*map(_round_bf16, inputs), causal, torch.float32)
  for name, g, w, t in zip(('o', 'dq', 'dk', 'dv'), got, want, truth):
    assert tile_rel_err(g, w) <= BF16_TOL, (name, tile_rel_err(g, w))
    assert tile_rel_err(g, t) <= BF16_TOL, (name, tile_rel_err(g, t))
