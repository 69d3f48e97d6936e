"""Decode attention of the PyTorch port vs the JAX package.

The plain version of the port's decode-attention kernel
(mt3_tpu_torch/ops/decode_attention.py) against the Pallas TPU kernel it
replaces, run in interpret mode as tests/test_pallas_decode_attention.py
runs it, and against the XLA decode path of layers.attention_decode_step.
Float32; outputs within atol 1e-5, caches equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt3_tpu.models import layers as jax_layers
from mt3_tpu.ops.pallas import decode_attention_v3
from mt3_tpu_torch.models import layers
from mt3_tpu_torch.ops import decode_attention

torch.set_num_threads(2)

B, H, D, LEN = 16, 6, 64, 512


def _inputs(index, seed=3):
  rng = np.random.RandomState(seed + index)
  query, new_k, new_v = (rng.randn(B, H, D).astype(np.float32)
                         for _ in range(3))
  # The cache holds positions < index; position index arrives as new_k/v.
  mask = (np.arange(LEN) < index).astype(np.float32)
  cache_k = rng.randn(B, H, D, LEN).astype(np.float32) * mask
  cache_v = rng.randn(B, H, D, LEN).astype(np.float32) * mask
  return query, new_k, new_v, cache_k, cache_v


def _port(query, new_k, new_v, cache_k, cache_v, index):
  ck, cv = torch.from_numpy(cache_k.copy()), torch.from_numpy(cache_v.copy())
  out = decode_attention.decode_attention_inplace(
      torch.from_numpy(query), torch.from_numpy(new_k),
      torch.from_numpy(new_v), ck, cv,
      torch.tensor(index, dtype=torch.int32))
  return out.numpy(), ck.numpy(), cv.numpy()


@pytest.mark.parametrize('index', [0, 5, 127, 128, 300, 511])
def test_plain_matches_pallas_kernel(index):
  query, new_k, new_v, cache_k, cache_v = _inputs(index)
  ref_out, ref_ck, ref_cv = decode_attention_v3.decode_attention_inplace(
      query, new_k, new_v, cache_k, cache_v, jnp.array(index),
      interpret=True)
  out, ck, cv = _port(query, new_k, new_v, cache_k, cache_v, index)
  np.testing.assert_allclose(out, np.asarray(ref_out), atol=1e-5, rtol=1e-5)
  np.testing.assert_array_equal(ck, np.asarray(ref_ck))
  np.testing.assert_array_equal(cv, np.asarray(ref_cv))
  # Positions after index are untouched.
  np.testing.assert_array_equal(ck[..., index + 1:], cache_k[..., index + 1:])


@pytest.mark.parametrize('impl', ['xla', 'pallas_v3'])
# LEN + 7: dynamic_update_slice clamps the write to the last column.
@pytest.mark.parametrize('index', [0, 130, 511, LEN + 7])
def test_attention_decode_step_matches_jax_xla(index, impl):
  emb, h, d, b, max_len = 64, 4, 16, 3, LEN
  rng = np.random.RandomState(index)
  params = {name: (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)
            for name, shape in (('query', (emb, h * d)), ('key', (emb, h * d)),
                                ('value', (emb, h * d)), ('out', (h * d, emb)))}
  x = rng.randn(b, emb).astype(np.float32)
  mask = (np.arange(max_len) < index).astype(np.float32)
  cache_k = rng.randn(b, h, d, max_len).astype(np.float32) * mask
  cache_v = rng.randn(b, h, d, max_len).astype(np.float32) * mask

  ref_out, ref_ck, ref_cv = jax_layers.attention_decode_step(
      params, x, cache_k, cache_v, jnp.array(index, jnp.int32), h, d,
      attention_impl='xla')
  ck, cv = torch.from_numpy(cache_k.copy()), torch.from_numpy(cache_v.copy())
  out, ck2, cv2 = layers.attention_decode_step(
      {k: torch.from_numpy(v) for k, v in params.items()},
      torch.from_numpy(x), ck, cv, torch.tensor(index, dtype=torch.int32),
      h, d, attention_impl=impl)
  assert ck2 is ck and cv2 is cv  # written in place
  np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
  np.testing.assert_array_equal(ck.numpy(), np.asarray(ref_ck))
  np.testing.assert_array_equal(cv.numpy(), np.asarray(ref_cv))


def test_plain_bf16_close_to_float32():
  """bf16 caches (the served dtype) against the port's own float32.

  Tolerance 5e-2: bf16 keeps 8 bits of mantissa and the plain version
  rounds logits, weights and output to bf16 as the XLA path does.  The
  query is scaled by 1/sqrt(d), as T5 folds that scale into its weights.
  """
  index = 300
  query, new_k, new_v, cache_k, cache_v = _inputs(index, seed=11)
  query = query / np.sqrt(D)
  out32, _, _ = _port(query, new_k, new_v, cache_k, cache_v, index)
  as_bf16 = [torch.from_numpy(a.copy()).to(torch.bfloat16)
             for a in (query, new_k, new_v, cache_k, cache_v)]
  out16 = decode_attention.decode_attention_inplace(
      *as_bf16, torch.tensor(index, dtype=torch.int32))
  assert out16.dtype == torch.bfloat16
  np.testing.assert_allclose(out16.float().numpy(), out32, atol=5e-2)
  assert torch.equal(as_bf16[3][..., index], as_bf16[1])

