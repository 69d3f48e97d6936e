"""Layers, encoder and decode step of the PyTorch port vs mt3_tpu.

Float32 parity: layers within atol 1e-5, encoder outputs and decode-step
logits within atol 1e-4.  The mt3-width cases use the published widths
(emb 512, 6 heads x 64, mlp 1024, 8+8 layers) with random weights.  The
JAX 'pallas_v3' decode runs its Pallas kernel in interpret mode.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mt3_tpu.core import config as jax_config
from mt3_tpu.models import layers as jax_layers
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.models import layers, t5

torch.set_num_threads(2)


def _t(x):
  return torch.from_numpy(np.array(x))


def _close(port, ref, atol):
  np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                             atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
RNG = np.random.RandomState(0)
EMB, HEADS, HEAD_DIM, MLP = 48, 3, 16, 64


def _randn(*shape, scale=1.0):
  return (RNG.randn(*shape) * scale).astype(np.float32)


def _attn_params():
  return {'query': _randn(EMB, HEADS * HEAD_DIM, scale=EMB ** -0.5),
          'key': _randn(EMB, HEADS * HEAD_DIM, scale=EMB ** -0.5),
          'value': _randn(EMB, HEADS * HEAD_DIM, scale=EMB ** -0.5),
          'out': _randn(HEADS * HEAD_DIM, EMB, scale=EMB ** -0.5)}


def test_rms_norm_and_dense():
  x, scale, kernel = _randn(2, 5, EMB), _randn(EMB), _randn(EMB, MLP)
  _close(layers.rms_norm(_t(scale), _t(x)), jax_layers.rms_norm(scale, x),
         1e-5)
  _close(layers.dense(_t(kernel), _t(x)), jax_layers.dense(kernel, x), 1e-5)


def test_gated_mlp():
  params = {'wi_0': _randn(EMB, MLP, scale=0.2), 'wi_1': _randn(EMB, MLP),
            'wo': _randn(MLP, EMB, scale=0.1)}
  x = _randn(2, 7, EMB)
  ref = jax_layers.gated_mlp(params, x, ('gelu', 'linear'))
  port = layers.gated_mlp({k: _t(v) for k, v in params.items()}, _t(x),
                          ('gelu', 'linear'))
  _close(port, ref, 1e-5)


def test_embed():
  table = _randn(37, EMB)
  ids = RNG.randint(0, 37, size=(3, 5)).astype(np.int32)
  _close(layers.embed(_t(table), _t(ids)), jax_layers.embed(table, ids), 1e-5)


@pytest.mark.parametrize('with_bias', [False, True])
def test_attention(with_bias):
  params = _attn_params()
  xq, xkv = _randn(2, 6, EMB), _randn(2, 9, EMB)
  tokens = np.array([[3, 4, 5, 0, 0, 0], [1, 2, 3, 4, 5, 6]], np.int32)
  bias = None
  if with_bias:
    bias = np.asarray(jax_layers.make_attention_bias(
        (tokens > 0).astype(np.float32), np.ones((2, 9), np.float32)))
  ref = jax_layers.attention(params, xq, xkv, bias, HEADS, HEAD_DIM)
  port = layers.attention({k: _t(v) for k, v in params.items()}, _t(xq),
                          _t(xkv), None if bias is None else _t(bias),
                          HEADS, HEAD_DIM)
  _close(port, ref, 1e-5)


def test_cross_attention_decode_step():
  params = _attn_params()
  x = _randn(4, EMB)
  keys, values = _randn(4, HEADS, HEAD_DIM, 11), _randn(4, HEADS, HEAD_DIM, 11)
  ref = jax_layers.cross_attention_decode_step(params, x, keys, values,
                                               HEADS, HEAD_DIM)
  port = layers.cross_attention_decode_step(
      {k: _t(v) for k, v in params.items()}, _t(x), _t(keys), _t(values),
      HEADS, HEAD_DIM)
  _close(port, ref, 1e-5)


def test_bias_builders():
  tokens = np.array([[5, 6, 7, 0], [9, 0, 0, 0]], np.int32)
  _close(layers.make_decoder_bias(_t(tokens)),
         jax_layers.make_decoder_bias(tokens), 0)
  _close(layers.make_causal_bias(5), jax_layers.make_causal_bias(5), 0)
  q = (tokens > 0).astype(np.float32)
  _close(layers.make_attention_bias(_t(q), _t(q)),
         jax_layers.make_attention_bias(q, q), 0)
  np.testing.assert_array_equal(layers.sinusoidal_table(64, 32),
                                jax_layers.sinusoidal_table(64, 32))


def test_kv_cache_init_and_growth():
  """The port preallocates the full length where JAX grows by buckets.

  A full-length cache whose first 8 columns were written equals the JAX
  8-slot cache with the same columns, grown to the full length.
  """
  cache = layers.init_kv_cache(2, 3, HEADS, HEAD_DIM, 20)
  ref = jax_layers.init_kv_cache(2, 3, HEADS, HEAD_DIM, 8)
  assert tuple(cache.key.shape) == ref.key.shape[:-1] + (20,)
  _close(cache.key, np.zeros(cache.key.shape, np.float32), 0)
  prefix_k, prefix_v = _randn(*ref.key.shape), _randn(*ref.value.shape)
  cache.key[..., :8] = _t(prefix_k)
  cache.value[..., :8] = _t(prefix_v)
  ref_grown = jax_layers.grow_kv_cache(
      jax_layers.KVCache(key=prefix_k, value=prefix_v), 20)
  _close(cache.key, ref_grown.key, 0)
  _close(cache.value, ref_grown.value, 0)
  # Quantized caches: int8 codes as JAX's, int4 packed two per uint8 along
  # head_dim; float32 scales [L, b, h, len], all zero.
  for bits, dtype, rows in ((8, torch.int8, HEAD_DIM),
                            (4, torch.uint8, HEAD_DIM // 2)):
    q = layers.init_kv_cache(2, 3, HEADS, HEAD_DIM, 8, quantized=True,
                             bits=bits)
    ref = jax_layers.init_kv_cache(2, 3, HEADS, HEAD_DIM, 8, quantized=True,
                                   bits=bits)
    assert q.quantized and ref.quantized
    assert q.key.dtype == q.value.dtype == dtype
    assert tuple(q.key.shape) == (2, 3, HEADS, rows, 8)
    assert tuple(q.key_scale.shape) == ref.key_scale.shape
    assert q.key_scale.dtype == torch.float32
    assert not q.key.any() and not q.value_scale.any()


# ---------------------------------------------------------------------------
# Encoder and decode step, tiny and mt3 widths
# ---------------------------------------------------------------------------
def _models(name):
  factory = {'tiny': 'tiny_config', 'mt3': 'mt3_config'}[name]
  jax_cfg = getattr(jax_config, factory)().model
  torch_cfg = getattr(torch_config, factory)().model
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(1), jax_cfg)
  numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
  return jax_cfg, jax_params, torch_cfg, params_lib.from_numpy_tree(
      numpy_params)


@pytest.fixture(scope='module')
def mt3_models():
  return _models('mt3')


@pytest.fixture(scope='module')
def tiny_models():
  return _models('tiny')


def _encoder_input(cfg, b, length, seed=0):
  return np.random.RandomState(seed).randn(
      b, length, cfg.input_depth).astype(np.float32)


@pytest.mark.parametrize('width', ['tiny', 'mt3'])
def test_encode_matches_jax(width, tiny_models, mt3_models):
  jax_cfg, jax_params, torch_cfg, torch_params = (
      tiny_models if width == 'tiny' else mt3_models)
  b, length = (2, 8) if width == 'tiny' else (1, 256)
  x = _encoder_input(jax_cfg, b, length)
  ref = jax.jit(jax_t5.encode, static_argnums=1)(jax_params, jax_cfg, x)
  port = t5.encode(torch_params, torch_cfg, _t(x))
  assert port.shape == (b, length, jax_cfg.emb_dim)
  _close(port, ref, 1e-4)


def _decode_steps_jax(jax_cfg, jax_params, encoded, tokens, max_len):
  state = jax_t5.init_decode_state(jax_params, jax_cfg, encoded, max_len)
  step = jax.jit(jax_t5.decode_step, static_argnums=1)
  logits = []
  for token in tokens:
    out, state = step(jax_params, jax_cfg, token, state)
    logits.append(np.asarray(out))
  return logits, state


def _decode_steps_port(torch_cfg, torch_params, encoded, tokens, max_len):
  state = t5.init_decode_state(torch_params, torch_cfg, _t(encoded), max_len)
  logits = []
  for token in tokens:
    out, state = t5.decode_step(torch_params, torch_cfg, _t(token), state)
    logits.append(out.numpy())
  return logits, state


@pytest.mark.parametrize('impl', ['xla', 'pallas_v3'])
def test_mt3_decode_steps_match_jax(impl, mt3_models):
  """8 consecutive decode steps at mt3 width, b=2, cache 128."""
  jax_cfg, jax_params, torch_cfg, torch_params = mt3_models
  jax_cfg = dataclasses.replace(jax_cfg, decode_attention_impl=impl)
  torch_cfg = dataclasses.replace(torch_cfg, decode_attention_impl=impl)
  rng = np.random.RandomState(2)
  encoded = rng.randn(2, 16, jax_cfg.emb_dim).astype(np.float32)
  tokens = rng.randint(3, jax_cfg.vocab_size, size=(8, 2)).astype(np.int32)
  with pltpu.force_tpu_interpret_mode():
    ref_logits, ref_state = _decode_steps_jax(jax_cfg, jax_params, encoded,
                                              tokens, 128)
  logits, state = _decode_steps_port(torch_cfg, torch_params, encoded,
                                     tokens, 128)
  for step, (a, b) in enumerate(zip(logits, ref_logits)):
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=0,
                               err_msg=f'decode step {step}')
  assert int(state.index) == int(ref_state.index) == 8
  _close(state.cache.key, ref_state.cache.key, 1e-5)
  _close(state.cache.value, ref_state.cache.value, 1e-5)
  _close(state.cross_k, ref_state.cross_k, 1e-5)


def test_tiny_decode_steps_match_jax(tiny_models):
  jax_cfg, jax_params, torch_cfg, torch_params = tiny_models
  rng = np.random.RandomState(4)
  encoded = rng.randn(3, 8, jax_cfg.emb_dim).astype(np.float32)
  tokens = rng.randint(3, jax_cfg.vocab_size, size=(12, 3)).astype(np.int32)
  ref_logits, _ = _decode_steps_jax(jax_cfg, jax_params, encoded, tokens, 16)
  logits, _ = _decode_steps_port(torch_cfg, torch_params, encoded, tokens, 16)
  for a, b in zip(logits, ref_logits):
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_bfloat16_close_to_float32(tiny_models):
  """bf16 activations against the port's own float32.

  Tolerance: encodings within 0.1 and logits within 0.25 (bf16 keeps ~3
  significant digits; rounding compounds over the layers; logits are
  O(1) here).
  """
  _, _, torch_cfg, torch_params = tiny_models
  bf16_cfg = dataclasses.replace(torch_cfg, dtype='bfloat16')
  x = _t(_encoder_input(torch_cfg, 2, 8, seed=5))
  enc32 = t5.encode(torch_params, torch_cfg, x)
  enc16 = t5.encode(torch_params, bf16_cfg, x)
  assert enc16.dtype == torch.bfloat16
  _close(enc16.float(), enc32.numpy(), 0.1)
  tokens = np.array([[5, 9], [7, 3], [11, 2]], np.int32)
  l32, _ = _decode_steps_port(torch_cfg, torch_params, enc32.numpy(),
                              tokens, 8)
  l16, _ = _decode_steps_port(bf16_cfg, torch_params, enc32.numpy(),
                              tokens, 8)
  for a, b in zip(l16, l32):
    assert a.dtype == np.float32
    np.testing.assert_allclose(a, b, atol=0.25, rtol=0)
