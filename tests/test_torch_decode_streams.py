"""Whole decodes of the JAX package's decode modes in the PyTorch port.

Greedy token streams at tiny width for each decode configuration and for
the production combination (int4 self-attention cache, int8 cross K/V,
one K/V head, the stacked carry), and a few steps of that combination at
mt3 width, against mt3_tpu on the same numpy-seeded inputs and parameters
(float32, on the CPU: the port's plain versions of kernel B).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.infer import decode as jax_decode
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.infer import decode
from mt3_tpu_torch.models import t5
from mt3_tpu_torch.ops import decode_attention

torch.set_num_threads(2)


def _t(x):
  return torch.from_numpy(np.array(x))


PRODUCTION = dict(decode_kv_quantize=True, decode_kv_bits=4,
                  decode_cross_kv_quantize=True, decode_cache_carry='stacked',
                  num_kv_heads=1)
CONFIGS = {
    'int8': dict(decode_kv_quantize=True),
    'int4_stacked': dict(decode_kv_quantize=True, decode_kv_bits=4,
                         decode_cache_carry='stacked'),
    'gqa2_int8_cross': dict(num_kv_heads=2, decode_cross_kv_quantize=True),
    'xla_int8dot': dict(decode_kv_quantize=True,
                        decode_attention_impl='xla_int8dot'),
    'onehot_gqa1': dict(decode_cache_update='onehot', num_kv_heads=1),
    'production': PRODUCTION,
}


def _tiny_models(**overrides):
  jax_cfg = dataclasses.replace(jax_config.tiny_config().model, **overrides)
  torch_cfg = dataclasses.replace(torch_config.tiny_config().model,
                                  **overrides)
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(0), jax_cfg)
  numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
  return jax_cfg, jax_params, torch_cfg, params_lib.from_numpy_tree(
      numpy_params)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_decode_tokens_matches_jax(name):
  """Greedy streams of 40 tokens (forbid_eos, 8 steps per iteration) for
  4 segments, identical to the JAX package's."""
  jax_cfg, jax_params, torch_cfg, torch_params = _tiny_models(
      **CONFIGS[name])
  encoded = np.random.RandomState(1).randn(4, 8, jax_cfg.emb_dim).astype(
      np.float32)
  ref_tokens, _ = jax_decode.decode_tokens(
      jax_params, jax_cfg, encoded, 40, forbid_eos=True, steps_per_iter=8)
  tokens, lengths = decode.decode_tokens(
      torch_params, torch_cfg, _t(encoded), 40, forbid_eos=True,
      steps_per_iter=8)
  np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
  assert np.all(lengths.numpy() == 40)


def test_mt3_production_decode_steps_match_jax():
  """6 steps at mt3 width with one K/V head, int4 cache, int8 cross K/V
  and the stacked carry, b=2, cache 64.

  Logits within 1e-3, codes at most one level apart, for this reason:

  the encoder K/V projections differ from XLA's in the last float32 bits
  (another sum order over 512 inputs), and a value that lies on a rounding
  boundary of its int8 code then lands one level apart: here 1 cross-key
  code of 16384.  One level is 1/127 of that vector's max and moves the
  logits by up to 4.4e-4 (3e-6 without the int8 cross K/V).  So: logits
  within 1e-3, cross codes at most one level apart at no more than 0.1%
  of entries, self-attention codes and scales likewise, at most one level.
  """
  jax_cfg = dataclasses.replace(jax_config.mt3_config().model, **PRODUCTION)
  torch_cfg = dataclasses.replace(torch_config.mt3_config().model,
                                  **PRODUCTION)
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(1), jax_cfg)
  torch_params = params_lib.from_numpy_tree(
      jax.tree_util.tree_map(np.asarray, jax_params))
  rng = np.random.RandomState(2)
  encoded = rng.randn(2, 16, jax_cfg.emb_dim).astype(np.float32)
  tokens = rng.randint(3, jax_cfg.vocab_size, size=(6, 2)).astype(np.int32)
  ref_state = jax_t5.init_decode_state(jax_params, jax_cfg, encoded, 64)
  state = t5.init_decode_state(torch_params, torch_cfg, _t(encoded), 64)
  step = jax.jit(jax_t5.decode_step, static_argnums=1)
  for i, token in enumerate(tokens):
    ref_logits, ref_state = step(jax_params, jax_cfg, token, ref_state)
    logits, state = t5.decode_step(torch_params, torch_cfg, _t(token), state)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-3, rtol=0, err_msg=f'step {i}')
  assert state.cache.key.shape == (8, 2, 1, 32, 64)
  assert state.cache.key.dtype == torch.uint8
  pairs = ((state.cross_k, ref_state.cross_k),
           (state.cross_v, ref_state.cross_v),
           (decode_attention.cache_codes(state.cache.key), ref_state.cache.key),
           (decode_attention.cache_codes(state.cache.value),
            ref_state.cache.value))
  for port, ref in pairs:
    diff = port.numpy().astype(int) - np.asarray(ref).astype(np.int8)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() <= 1e-3
  # The scales follow max|x| of those projections: within 1e-5 relative.
  np.testing.assert_allclose(state.cross_k_scale.numpy(),
                             np.asarray(ref_state.cross_k_scale), rtol=1e-5)
