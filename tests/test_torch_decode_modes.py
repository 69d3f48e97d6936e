"""The JAX package's decode modes in the PyTorch port, against mt3_tpu.

Quantized (int8, int4) self-attention caches, grouped-query attention,
int8 cross-attention K/V, 'xla_int8dot', 'onehot' and the stacked carry:
the same numpy-seeded inputs and parameters go through the JAX function
and its port on the CPU (the port's plain versions of kernel B).

Tolerances: float32 outputs within 1e-5 (sums of at most a few hundred
float32 products, in another order), decode-step logits within 1e-4 as in
tests/test_torch_model.py; quantization codes, scales and caches equal
(int4 caches compared unpacked); greedy token streams identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.models import layers as jax_layers
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu.train import checkpoint as jax_checkpoint
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.models import layers, t5
from mt3_tpu_torch.ops import decode_attention

torch.set_num_threads(2)


def _t(x):
  return torch.from_numpy(np.array(x))


def _np(x):
  """A JAX array as numpy; int4 arrays widened to int8."""
  x = np.asarray(x)
  return x.astype(np.int8) if x.dtype == jnp.int4 else x


def _codes(port_cache):
  """A port cache's codes as numpy int8 (int4 unpacked) or its values."""
  return decode_attention.cache_codes(port_cache).numpy()


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('bits', [8, 4])
def test_quantize_kv_matches_jax(bits, dtype):
  """Codes and scales equal to _quantize_kv's under jit, as the decode step
  runs it, on vectors of spread magnitudes.  (Under jit XLA turns
  max|x| / levels into a product with the float32 reciprocal; run op by
  op, JAX divides, and about 5% of the float32 scales then differ by one
  ulp.)"""
  rng = np.random.RandomState(bits)
  x = (rng.randn(64, 6, 64) * rng.exponential(1.0, (64, 6, 1))).astype(
      np.float32)
  x[0, 0] = 0.0   # the 1e-8 floor
  jdtype = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
  xj = jnp.asarray(x).astype(jdtype)
  qdtype = jnp.int4 if bits == 4 else jnp.int8
  codes, scale = layers._quantize_kv(
      _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype)), bits)
  ref_codes, ref_scale = jax.jit(jax_layers._quantize_kv,
                                 static_argnums=1)(xj, qdtype)
  np.testing.assert_array_equal(codes.numpy(), _np(ref_codes))
  np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))
  assert codes.dtype == torch.int8 and scale.dtype == torch.float32
  assert int(codes.abs().max()) == (7 if bits == 4 else 127)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_quantize_kv_sequence_matches_jax(dtype):
  rng = np.random.RandomState(7)
  x = (rng.randn(2, 3, 4, 16, 40) * 3).astype(np.float32)
  jdtype = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
  xj = jnp.asarray(x).astype(jdtype)
  ref_codes, ref_scale = jax.jit(jax_layers.quantize_kv_sequence)(xj)
  codes, scale = layers.quantize_kv_sequence(
      _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype)))
  np.testing.assert_array_equal(codes.numpy(), _np(ref_codes))
  np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))


def test_int4_pack_round_trip():
  """Row r of a packed cache holds dims 2r (low nibble) and 2r+1 (high)."""
  codes = torch.from_numpy(
      np.random.RandomState(0).randint(-8, 8, (2, 3, 8, 5)).astype(np.int8))
  packed = decode_attention.pack_int4(codes)
  assert packed.dtype == torch.uint8 and packed.shape == (2, 3, 4, 5)
  assert torch.equal(decode_attention.unpack_int4(packed), codes)
  low = (packed[0, 0, 1, 2] & 15).item()
  assert low == (int(codes[0, 0, 2, 2]) & 15)
  assert (packed[0, 0, 1, 2] >> 4).item() == (int(codes[0, 0, 3, 2]) & 15)


# ---------------------------------------------------------------------------
# attention_decode_step and self_attention_decode_stacked, every branch
# ---------------------------------------------------------------------------
EMB, HEADS, HEAD_DIM, B, LEN = 32, 4, 8, 3, 96

# name -> (kv heads, cache bits or None, attention_impl, cache_update)
MODES = {
    'int8': (4, 8, 'xla', 'dus'),
    'int4': (4, 4, 'xla', 'dus'),
    'gqa': (2, None, 'xla', 'dus'),
    'gqa_int4': (2, 4, 'xla', 'dus'),
    'gqa1_int8': (1, 8, 'xla', 'dus'),
    'xla_int8dot': (4, 8, 'xla_int8dot', 'dus'),
    'xla_int8dot_int4': (4, 4, 'xla_int8dot', 'dus'),
    'xla_int8dot_gqa': (2, 8, 'xla_int8dot', 'dus'),   # the grouped branch
    'onehot': (4, None, 'xla', 'onehot'),
    'onehot_gqa': (2, None, 'xla', 'onehot'),
}


def _step_inputs(kv, bits, index, seed):
  """Parameters, x and one layer's caches; positions >= index are zero,
  as a decode leaves them (the onehot update adds to the column).  x and
  the weights are multiples of 1/8 and 1/64, so that the projections are
  exact in float32 and equal in both frameworks whatever their sum order:
  the new column is quantized from the same values."""
  rng = np.random.RandomState(seed)
  params = {
      name: (rng.randint(-8, 9, shape) / 64).astype(np.float32)
      for name, shape in (('query', (EMB, HEADS * HEAD_DIM)),
                          ('key', (EMB, kv * HEAD_DIM)),
                          ('value', (EMB, kv * HEAD_DIM)),
                          ('out', (HEADS * HEAD_DIM, EMB)))}
  x = (rng.randint(-8, 9, (B, EMB)) / 8).astype(np.float32)
  live = (np.arange(LEN) < index)
  shape = (B, kv, HEAD_DIM, LEN)
  if bits is None:
    caches = [(rng.randn(*shape) * live).astype(np.float32)
              for _ in range(2)]
    return params, x, caches, None
  levels = 7 if bits == 4 else 127
  caches = [(rng.randint(-levels, levels + 1, shape) * live).astype(np.int8)
            for _ in range(2)]
  scales = [(rng.uniform(0.2, 1.0, (B, kv, LEN)) / levels * live).astype(
      np.float32) for _ in range(2)]
  return params, x, caches, scales


def _jax_caches(caches, bits):
  qdtype = jnp.int4 if bits == 4 else jnp.int8
  return [jnp.asarray(c).astype(qdtype) if bits else jnp.asarray(c)
          for c in caches]


def _port_caches(caches, bits):
  port = [_t(c) for c in caches]
  return [decode_attention.pack_int4(c) for c in port] if bits == 4 else port


# The JAX decode step runs under jit, and XLA compiles the quantization's
# max|x| / levels as a product with the reciprocal there (see
# test_quantize_kv_matches_jax): the reference is the jitted function.
_JAX_STEP = jax.jit(
    jax_layers.attention_decode_step,
    static_argnames=('num_heads', 'head_dim', 'cache_update',
                     'attention_impl', 'num_kv_heads'))


def _check_step(out, caches, scales, ref, atol=1e-5):
  np.testing.assert_allclose(out.numpy(), np.asarray(ref[0]), atol=atol,
                             rtol=0)
  for port, want in zip(caches, ref[1:3]):
    np.testing.assert_array_equal(_codes(port), _np(want))
  if scales is not None:
    for port, want in zip(scales, ref[3:5]):
      np.testing.assert_array_equal(port.numpy(), np.asarray(want))


@pytest.mark.parametrize('index', [0, 37, 64, LEN - 1])
@pytest.mark.parametrize('mode', sorted(MODES))
def test_attention_decode_step_matches_jax(mode, index):
  kv, bits, impl, update = MODES[mode]
  params, x, caches, scales = _step_inputs(kv, bits, index,
                                           seed=index + len(mode))
  idx = jnp.array(index, jnp.int32)
  jax_scales = ([jnp.asarray(s) for s in scales] if scales else [None] * 2)
  ref = _JAX_STEP(
      params, x, *_jax_caches(caches, bits), idx, num_heads=HEADS,
      head_dim=HEAD_DIM, cache_update=update, attention_impl=impl,
      cache_k_scale=jax_scales[0], cache_v_scale=jax_scales[1],
      num_kv_heads=kv)
  port_caches = _port_caches(caches, bits)
  port_scales = [_t(s) for s in scales] if scales else None
  result = layers.attention_decode_step(
      {k: _t(v) for k, v in params.items()}, _t(x), *port_caches,
      torch.tensor(index, dtype=torch.int32), HEADS, HEAD_DIM,
      cache_update=update, attention_impl=impl,
      cache_k_scale=port_scales[0] if scales else None,
      cache_v_scale=port_scales[1] if scales else None, num_kv_heads=kv)
  assert len(result) == len(ref)
  assert all(a is b for a, b in zip(result[1:], port_caches
                                    + (port_scales or [])))   # in place
  _check_step(result[0], port_caches, port_scales, ref)


@pytest.mark.parametrize('mode', ['float', 'int8', 'int4', 'gqa_int4',
                                  'xla_int8dot'])
def test_self_attention_decode_stacked_matches_jax(mode):
  """Layer 1 of a 2-layer stacked cache: layer 0 stays as it was."""
  kv, bits, impl, _ = MODES.get(mode, (HEADS, None, 'xla', 'dus'))
  index = 50
  params, x, caches, scales = _step_inputs(kv, bits, index, seed=3)
  other = _step_inputs(kv, bits, index, seed=4)
  stacked = [np.stack([o, c]) for o, c in zip(other[2], caches)]
  stacked_scales = ([np.stack([o, s]) for o, s in zip(other[3], scales)]
                    if scales else None)
  ref_cache = jax_layers.KVCache(
      *_jax_caches(stacked, bits),
      *([jnp.asarray(s) for s in stacked_scales] if scales else []))
  ref_out, ref_new = jax.jit(
      jax_layers.self_attention_decode_stacked,
      static_argnames=('layer', 'num_heads', 'head_dim', 'attention_impl',
                       'num_kv_heads'))(
          params, x, ref_cache, layer=1,
          cache_index=jnp.array(index, jnp.int32), num_heads=HEADS,
          head_dim=HEAD_DIM, attention_impl=impl, num_kv_heads=kv)
  cache = layers.KVCache(*_port_caches(stacked, bits),
                         *([_t(s) for s in stacked_scales] if scales else []))
  out, new = layers.self_attention_decode_stacked(
      {k: _t(v) for k, v in params.items()}, _t(x), cache, 1,
      torch.tensor(index, dtype=torch.int32), HEADS, HEAD_DIM,
      attention_impl=impl, num_kv_heads=kv)
  assert new is cache
  _check_step(out, [cache.key, cache.value],
              [cache.key_scale, cache.value_scale] if scales else None,
              (ref_out, ref_new.key, ref_new.value, ref_new.key_scale,
               ref_new.value_scale))


@pytest.mark.parametrize('kv,quantized', [(4, True), (2, False), (1, True)])
def test_cross_attention_decode_step_matches_jax(kv, quantized):
  rng = np.random.RandomState(kv)
  params = {
      name: (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)
      for name, shape in (('query', (EMB, HEADS * HEAD_DIM)),
                          ('out', (HEADS * HEAD_DIM, EMB)))}
  x = rng.randn(B, EMB).astype(np.float32)
  keys, values = (rng.randn(B, kv, HEAD_DIM, 24).astype(np.float32) * 2
                  for _ in range(2))
  ref_kv, port_kv = [keys, values, None, None], [_t(keys), _t(values),
                                                 None, None]
  if quantized:
    (rk, rks), (rv, rvs) = (jax_layers.quantize_kv_sequence(a)
                            for a in (keys, values))
    ref_kv = [rk, rv, rks, rvs]
    (pk, pks), (pv, pvs) = (layers.quantize_kv_sequence(t)
                            for t in port_kv[:2])
    port_kv = [pk, pv, pks, pvs]
  ref = jax_layers.cross_attention_decode_step(
      params, x, ref_kv[0], ref_kv[1], HEADS, HEAD_DIM, num_kv_heads=kv,
      key_scale=ref_kv[2], value_scale=ref_kv[3])
  port = layers.cross_attention_decode_step(
      {k: _t(v) for k, v in params.items()}, _t(x), port_kv[0], port_kv[1],
      HEADS, HEAD_DIM, num_kv_heads=kv, key_scale=port_kv[2],
      value_scale=port_kv[3])
  np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5,
                             rtol=0)


# ---------------------------------------------------------------------------
# The JAX package's errors, raised by the port in the same cases
# ---------------------------------------------------------------------------
def _error_case(case):
  """(jax callable, port callable) for one misuse."""
  kv, bits = (2, None) if case == 'pallas_v3_gqa' else (
      (HEADS, 8) if case == 'pallas_quantized' else (HEADS, None))
  params, x, caches, scales = _step_inputs(kv, bits, 5, seed=1)
  tparams = {k: _t(v) for k, v in params.items()}
  jidx, tidx = jnp.array(5, jnp.int32), torch.tensor(5, dtype=torch.int32)
  jsc = [jnp.asarray(s) for s in scales] if scales else [None, None]
  tsc = [_t(s) for s in scales] if scales else [None, None]
  if case in ('xla_int8dot_float', 'pallas_quantized', 'pallas_v3_gqa'):
    impl = 'xla_int8dot' if case == 'xla_int8dot_float' else 'pallas_v3'
    return (lambda: jax_layers.attention_decode_step(
        params, x, *_jax_caches(caches, bits), jidx, HEADS, HEAD_DIM,
        attention_impl=impl, cache_k_scale=jsc[0], cache_v_scale=jsc[1],
        num_kv_heads=kv),
            lambda: layers.attention_decode_step(
        tparams, _t(x), *_port_caches(caches, bits), tidx, HEADS, HEAD_DIM,
        attention_impl=impl, cache_k_scale=tsc[0], cache_v_scale=tsc[1],
        num_kv_heads=kv))
  if case in ('stacked_pallas', 'stacked_int8dot_float'):
    impl = 'pallas_v3' if case == 'stacked_pallas' else 'xla_int8dot'
    jcache = jax_layers.KVCache(*[c[None] for c in _jax_caches(caches, bits)])
    tcache = layers.KVCache(*[c[None] for c in _port_caches(caches, bits)])
    return (lambda: jax_layers.self_attention_decode_stacked(
        params, x, jcache, 0, jidx, HEADS, HEAD_DIM, attention_impl=impl),
            lambda: layers.self_attention_decode_stacked(
        tparams, _t(x), tcache, 0, tidx, HEADS, HEAD_DIM,
        attention_impl=impl))
  # case == 'stacked_onehot': _decode_step_stacked needs cache_update 'dus'.
  jcfg = dataclasses.replace(jax_config.tiny_config().model,
                             decode_cache_carry='stacked',
                             decode_cache_update='onehot')
  tcfg = dataclasses.replace(torch_config.tiny_config().model,
                             decode_cache_carry='stacked',
                             decode_cache_update='onehot')
  return (lambda: jax_t5.decode_step(None, jcfg, None, None),
          lambda: t5.decode_step(None, tcfg, None, None))


@pytest.mark.parametrize('case', [
    'xla_int8dot_float', 'pallas_quantized', 'pallas_v3_gqa',
    'stacked_pallas', 'stacked_int8dot_float', 'stacked_onehot'])
def test_port_raises_jax_errors(case):
  jax_fn, port_fn = _error_case(case)
  with pytest.raises(Exception) as ref:
    jax_fn()
  assert type(ref.value) in (ValueError, NotImplementedError), ref.value
  with pytest.raises(type(ref.value)) as got:
    port_fn()
  assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# The forward pass with grouped K/V heads, and the GQA conversion
# ---------------------------------------------------------------------------
def _tiny_models(**overrides):
  jax_cfg = dataclasses.replace(jax_config.tiny_config().model, **overrides)
  torch_cfg = dataclasses.replace(torch_config.tiny_config().model,
                                  **overrides)
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(0), jax_cfg)
  numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
  return jax_cfg, jax_params, torch_cfg, params_lib.from_numpy_tree(
      numpy_params)


def test_forward_with_grouped_kv_heads_matches_jax():
  jax_cfg, jax_params, torch_cfg, torch_params = _tiny_models(num_kv_heads=2)
  assert torch_params['decoder']['layers']['self_attention']['key'].shape == (
      2, jax_cfg.emb_dim, 2 * jax_cfg.head_dim)
  rng = np.random.RandomState(3)
  x = rng.randn(2, 8, jax_cfg.input_depth).astype(np.float32)
  targets = rng.randint(3, jax_cfg.vocab_size, size=(2, 6)).astype(np.int32)
  targets[1, 4:] = 0
  inputs = np.concatenate([np.zeros((2, 1), np.int32), targets[:, :-1]], 1)
  ref = jax_t5.forward(jax_params, jax_cfg, x, inputs, targets)
  port = t5.forward(torch_params, torch_cfg, _t(x), _t(inputs), _t(targets))
  np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                             atol=1e-4, rtol=0)


def test_convert_mha_to_gqa_matches_jax():
  _, jax_params, _, torch_params = _tiny_models()
  cfg = jax_config.tiny_config().model
  for kv in (2, 1):
    ref = jax_checkpoint.convert_mha_to_gqa(
        jax_params, cfg.num_heads, cfg.head_dim, kv, allow_unfinetuned=True)
    port = params_lib.convert_mha_to_gqa(
        torch_params, cfg.num_heads, cfg.head_dim, kv,
        allow_unfinetuned=True)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    port_leaves = params_lib.tree_leaves(port)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(port_leaves, ref_leaves):
      np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert port['encoder']['layers']['attention']['value'].shape[-1] == (
        kv * cfg.head_dim)
  with pytest.raises(ValueError, match='recovery finetune'):
    params_lib.convert_mha_to_gqa(torch_params, cfg.num_heads, cfg.head_dim,
                                  1)
  with pytest.raises(ValueError, match='not divisible'):
    params_lib.convert_mha_to_gqa(torch_params, cfg.num_heads, cfg.head_dim,
                                  3, allow_unfinetuned=True)
