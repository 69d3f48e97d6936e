"""Kernel C's plain version against the stock TPU flash-attention kernel.

mt3_tpu_torch.ops.flash_attention.flash_attention_plain (what the port runs
on a CPU tensor, and what chip_smoke.py holds the CUDA kernels against) and
its autograd backward are compared with
jax.experimental.pallas.ops.tpu.flash_attention.flash_attention, run in
interpret mode with the block sizes mt3_tpu/models/layers.py gives it, on
the same numpy inputs.  Causal and full, (lq, lk) in {(128, 128),
(256, 128)}, head dims 8 and 64; float32 here, bfloat16 in
test_torch_flash_attention_bf16.py (split to keep each file short).

Tolerances, for each of o, dq, dk and dv:
  * float32: 2e-5 * (1 + |x|) elementwise.  Both sides sum 128-256
    float32 products (o, dk, dv within 2e-6).  dq of a causal row's first
    keys is p * (dP - di) with dP and di nearly equal: the stock kernel
    forms di with XLA and dP in the kernel, in two sum orders, and leaves
    up to 1.2e-5 where autograd's softmax backward gives ~0.
  * bfloat16 inputs: relative error ||g - w||_2 / ||w||_2 <= 1e-2 in
    every 64-row block of every (batch, head), of the plain version
    against the stock kernel, and against the float32 truth (the plain
    version in float32 on the same bf16-rounded inputs).  Both sides
    round p or dP, dS and the outputs to bfloat16 (2**-9 relative), in
    different places, and measure 2-5e-3.  No elementwise limit: dq is a
    cancelling sum whose rounding follows the size of its terms, not its
    own, and the stock kernel itself is 4.5e-2 * (1 + |w|) off the truth
    in causal first rows.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax.experimental.pallas.tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as stock
from mt3_tpu_torch.ops import flash_attention

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_TOL = 1e-2
CASES = list(itertools.product(((128, 128), (256, 128)), (True, False),
                               (8, 64)))


def _block_sizes(lq, lk):
  """As mt3_tpu/models/layers.py:232-238."""
  bq, bk = min(512, lq), min(512, lk)
  return stock.BlockSizes(
      block_q=bq, block_k_major=bk, block_k=bk, block_b=1,
      block_q_major_dkv=bq, block_k_major_dkv=bk, block_k_dkv=bk,
      block_q_dkv=bq, block_k_major_dq=bk, block_k_dq=bk, block_q_dq=bq)


def _inputs(lq, lk, d, seed):
  rng = np.random.RandomState(seed)
  b, h = 2, 2
  # Scores of unit variance, as the 1/sqrt(d)-scaled query init gives.
  q = rng.randn(b, h, lq, d).astype(np.float32) / np.sqrt(d)
  k = rng.randn(b, h, lk, d).astype(np.float32)
  v = rng.randn(b, h, lk, d).astype(np.float32)
  do = rng.randn(b, h, lq, d).astype(np.float32) / 2
  return q, k, v, do


def _stock(q, k, v, do, causal, dtype):
  lq, lk = q.shape[2], k.shape[2]
  args = [jnp.asarray(x, dtype) for x in (q, k, v)]
  with pltpu.force_tpu_interpret_mode():
    o, vjp = jax.vjp(
        lambda q, k, v: stock.flash_attention(
            q, k, v, causal=causal, sm_scale=1.0,
            block_sizes=_block_sizes(lq, lk)), *args)
    grads = vjp(jnp.asarray(do, dtype))
  return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def tile_rel_err(got, want, tile=64):
  """Largest ||got - want||_2 / ||want||_2 over the `tile`-row blocks of
  each (batch, head) of [b, h, len, d] arrays."""
  b, h, length, d = want.shape
  shape = (b, h, length // tile, tile * d)
  diff = np.linalg.norm((got - want).reshape(shape), axis=-1)
  return (diff / np.linalg.norm(want.reshape(shape), axis=-1)).max()


def _plain(q, k, v, do, causal, dtype):
  args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
  o = flash_attention.flash_attention(*args, causal=causal, sm_scale=1.0)
  grads = torch.autograd.grad(o, args, torch.from_numpy(do).to(dtype))
  return [x.detach().float().numpy() for x in (o, *grads)]


@pytest.mark.parametrize('lengths,causal,head_dim', CASES)
def test_plain_matches_stock_kernel_float32(lengths, causal, head_dim):
  lq, lk = lengths
  inputs = _inputs(lq, lk, head_dim, seed=lq + lk + head_dim + causal)
  want = _stock(*inputs, causal, jnp.float32)
  got = _plain(*inputs, causal, torch.float32)
  for name, g, w in zip(('o', 'dq', 'dk', 'dv'), got, want):
    excess = np.abs(g - w) - F32_TOL * (1 + np.abs(w))
    assert excess.max() <= 0, (name, np.abs(g - w).max())


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
  q, k, v, _ = _inputs(128, 128, 64, seed=3)
  args = [torch.from_numpy(x) for x in (q, k, v)]
  before = dict(flash_attention.LAUNCHES)
  got = flash_attention.flash_attention(*args, causal=True)
  want = flash_attention.flash_attention_plain(*args, causal=True)
  assert torch.equal(got, want)
  assert flash_attention.LAUNCHES == before


def test_wrapper_raises_off_cpu_and_cuda():
  """A meta tensor (neither CPU nor CUDA) goes to the kernel, which
  refuses it; nothing falls back to the plain version."""
  q = torch.empty(1, 6, 128, 64, device='meta')
  with pytest.raises(ValueError, match='CUDA'):
    flash_attention.flash_attention(q, q, q, causal=False)


def test_wrapper_raises_on_unsupported_head_dim(monkeypatch):
  """Head dims other than 64 raise before any launch (the CUDA check is
  faked: there is no card here)."""
  q = torch.empty(1, 4, 128, 8, device='meta')
  monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda self: True))
  with pytest.raises(ValueError, match='head_dim 8'):
    flash_attention.flash_attention(q, q, q, causal=True)
  with pytest.raises(ValueError, match='float32 or bfloat16'):
    h = torch.empty(1, 4, 128, 64, device='meta', dtype=torch.float16)
    flash_attention.flash_attention(h, h, h, causal=True)
  assert flash_attention.HEAD_DIMS == (64,)
