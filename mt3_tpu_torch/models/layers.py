"""Neural-net building blocks (PyTorch port of mt3_tpu/models/layers.py).

Plain functions of (parameter dict, tensors), as in the JAX package:

  * Dense kernels are stored 2-D [in_features, out_features] like t5x
    DenseGeneral, so the JAX parameter tree converts with no transposes
    (see mt3_tpu_torch/params.py).
  * Matmuls cast to a compute dtype (bfloat16 when served) while parameters
    and norm statistics stay float32.  Float32 products run in true float32:
    the port never turns TF32 on (the JAX package asks for HIGHEST precision,
    layers.matmul_precision).
  * Decode caches are [layers, batch, kv_heads, head_dim, length], the JAX
    layout, and are updated in place: a decode step writes one column.
    int4 caches pack two codes per uint8 along head_dim,
    [layers, batch, kv_heads, head_dim / 2, length] (JAX keeps int4
    arrays unpacked).

Ported here: full attention with training-time dropout, grouped K/V heads
and the flash route (kernel C, ops/flash_attention.py), and every decode
mode of the JAX package: float32/bf16, int8 and int4 self-attention
caches, grouped-query attention, int8 cross-attention K/V, the 'scan' and
the 'stacked' carry.  The decode self-attention goes through the
decode-attention kernel (ops/decode_attention.py: kernel B on a CUDA
tensor, its plain version on a CPU tensor) for attention_impl 'xla' and
'pallas_v3', which name two TPU implementations of one function;
'xla_int8dot' with one query head per K/V head is plain torch, as XLA
computes it.  cache_update 'onehot' writes the same caches as 'dus' for
finite K/V, so it takes the same in-place write.

Every function takes `mesh` (parallel/partitioning.Mesh, None for one
device).  With a mesh the parameters are this rank's shards
(partitioning.model_dims): attention computes the rank's whole heads
(partitioning.head_layout) and the MLP its columns of wi and rows of wo,
each between copy_to_model and an all-reduce of the output over 'model'
(reduce_from_model); the embedding table holds the rank's vocab rows.
Dropout masks are drawn at the global shape from the shared generator and
sliced, so every model rank of a replicated activation draws the same
mask and a mesh run draws the single-device run's masks.  With mesh=None
nothing of this runs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mt3_tpu_torch.ops import decode_attention, flash_attention
from mt3_tpu_torch.parallel import partitioning
from mt3_tpu_torch.parallel.partitioning import Mesh

Params = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# Sinusoidal position table
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def sinusoidal_table(max_len: int, features: int, min_scale: float = 1.0,
                     max_scale: float = 10000.0) -> np.ndarray:
  """Fixed sinusoidal embeddings [max_len, features] (sin half, cos half)."""
  pe = np.zeros((max_len, features), dtype=np.float32)
  position = np.arange(0, max_len)[:, np.newaxis]
  scale_factor = -np.log(max_scale / min_scale) / (features // 2 - 1)
  div_term = min_scale * np.exp(np.arange(0, features // 2) * scale_factor)
  pe[:, :features // 2] = np.sin(position * div_term)
  pe[:, features // 2:2 * (features // 2)] = np.cos(position * div_term)
  return pe


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------
def rms_norm(scale: torch.Tensor, x: torch.Tensor, epsilon: float = 1e-6,
             dtype=torch.float32) -> torch.Tensor:
  """T5 LayerNorm: RMS only, no mean subtraction, float32 statistics."""
  x = x.to(torch.float32)
  mean2 = torch.mean(x * x, dim=-1, keepdim=True)
  y = (x * torch.rsqrt(mean2 + epsilon)).to(dtype)
  return y * scale.to(dtype)


def dense(kernel: torch.Tensor, x: torch.Tensor,
          dtype=torch.float32) -> torch.Tensor:
  """y = x @ kernel with kernel stored 2-D [in_features, out_features]."""
  return torch.matmul(x.to(dtype), kernel.to(dtype))


def _activation(name: str):
  if name == 'linear':
    return lambda x: x
  if name == 'gelu':
    # flax.linen.gelu (and the JAX package) use the tanh approximation.
    return functools.partial(F.gelu, approximate='tanh')
  return getattr(F, name)


def gated_mlp(params: Params, x: torch.Tensor, activations: Sequence[str],
              dtype=torch.float32, mesh: Optional[Mesh] = None
              ) -> torch.Tensor:
  """gelu(x @ wi_0) * (x @ wi_1) @ wo for activations ('gelu', 'linear')."""
  x = partitioning.copy_to_model(x, mesh)
  h = None
  for idx, act_name in enumerate(activations):
    name = 'wi' if len(activations) == 1 else f'wi_{idx}'
    a = _activation(act_name)(dense(params[name], x, dtype))
    h = a if h is None else h * a
  return partitioning.reduce_from_model(dense(params['wo'], h, dtype), mesh)


def embed(table: torch.Tensor, ids: torch.Tensor,
          dtype=torch.float32, mesh: Optional[Mesh] = None) -> torch.Tensor:
  """Token embedding lookup as a one-hot contraction, as the JAX package does.

  With a mesh the table holds this rank's block of vocab rows: ids outside
  it contract with zeros, and the ranks' lookups are summed (exactly: one
  term is not zero).
  """
  if mesh is None:
    one_hot_ids = F.one_hot(ids.to(torch.long), table.shape[0]).to(dtype)
    return torch.matmul(one_hot_ids, table.to(dtype))
  rows = table.shape[0]
  local = ids.to(torch.long) - mesh.model_index * rows
  inside = (local >= 0) & (local < rows)
  one_hot_ids = F.one_hot(torch.where(inside, local, 0), rows).to(dtype)
  one_hot_ids = one_hot_ids * inside[..., None].to(dtype)
  return partitioning.reduce_from_model(
      torch.matmul(one_hot_ids, table.to(dtype)), mesh)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def dropout_keep(generator: torch.Generator, shape, rate: float,
                 device, mesh: Optional[Mesh] = None,
                 model_dim: Optional[int] = None) -> torch.Tensor:
  """Boolean keep mask, True with probability 1 - rate (uniform < 1 - rate,
  as jax.random.bernoulli draws it).

  With a mesh, `shape` is this rank's block (its rows of dim 0 and, with
  model_dim, its part of that dimension): the mask is drawn at the global
  shape and the block returned.
  """
  if mesh is None:
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate
  full = list(shape)
  full[0] *= mesh.data
  if model_dim is not None:
    full[model_dim] *= mesh.model
  keep = torch.rand(full, generator=generator, device=device) < 1.0 - rate
  return partitioning.local_block(keep, mesh, model_dim)


def _kv_kernels(params: Params, layout: partitioning.HeadLayout,
                mesh: Optional[Mesh]):
  """The key and value kernels of the rank's K/V heads: the parameters,
  or, for K/V kernels replicated over 'model', their columns of those
  heads (the gradient summed over the model group)."""
  if layout.kv_columns is None:
    return params['key'], params['value']
  return tuple(partitioning.copy_to_model(params[name], mesh)[
      ..., layout.kv_columns] for name in ('key', 'value'))


def attention(params: Params, inputs_q: torch.Tensor,
              inputs_kv: torch.Tensor, bias: Optional[torch.Tensor],
              num_heads: int, head_dim: int, dtype=torch.float32,
              dropout_generator: Optional[torch.Generator] = None,
              dropout_rate: float = 0.0,
              num_kv_heads: Optional[int] = None,
              flash_mode: Optional[str] = None,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
  """Full (non-incremental) multi-head dot-product attention.

  inputs_q [b, q, emb], inputs_kv [b, k, emb], bias additive
  [b, 1|h, q, k] or None.  Softmax in float32.

  Attention dropout (with a generator and rate > 0) is the reference's
  query-broadcast weight dropout: one keep mask [b, h, 1, k] per call.

  flash_mode 'causal'/'full' takes the flash route (kernel C) when
  min(q, k) >= 128, as the JAX package does: the bias is ignored there
  (callers pass flash_mode only where it is exactly the causal mask or no
  mask at the positions that carry loss), and the dropout mask, drawn
  exactly as on the einsum route, is folded into V before the kernel,
  which is exact for a query-broadcast mask.

  With a mesh, a cross-attention's inputs_kv must already have passed
  partitioning.copy_to_model (t5.decode_train copies the encoder output
  once for every layer).
  """
  b, q_len, _ = inputs_q.shape
  k_len = inputs_kv.shape[1]
  layout = partitioning.head_layout(num_heads, num_kv_heads, head_dim, mesh)
  num_heads, kv_heads = layout.heads, layout.kv_heads
  self_attention = inputs_kv is inputs_q
  inputs_q = partitioning.copy_to_model(inputs_q, mesh)
  if self_attention:
    inputs_kv = inputs_q
  key_kernel, value_kernel = _kv_kernels(params, layout, mesh)
  query = dense(params['query'], inputs_q, dtype).reshape(
      b, q_len, num_heads, head_dim)
  key = dense(key_kernel, inputs_kv, dtype).reshape(
      b, k_len, kv_heads, head_dim)
  value = dense(value_kernel, inputs_kv, dtype).reshape(
      b, k_len, kv_heads, head_dim)
  if kv_heads != num_heads:
    group = num_heads // kv_heads
    key = torch.repeat_interleave(key, group, dim=2)
    value = torch.repeat_interleave(value, group, dim=2)

  if flash_mode not in (None, 'causal', 'full'):
    raise ValueError(f'unknown flash_mode: {flash_mode}')
  dropout = dropout_generator is not None and dropout_rate > 0.0
  if dropout:
    keep = dropout_keep(dropout_generator, (b, num_heads, 1, k_len),
                        dropout_rate, inputs_q.device, mesh, model_dim=1)
    mult = keep.to(dtype) / torch.tensor(1.0 - dropout_rate, dtype=dtype)

  if flash_mode is not None and min(q_len, k_len) >= 128:
    if dropout:
      value = value * mult.permute(0, 3, 1, 2)  # [b, k, h, 1]
    out = flash_attention.flash_attention(
        query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
        causal=(flash_mode == 'causal'), sm_scale=1.0)
    out = out.transpose(1, 2).to(dtype)
    return partitioning.reduce_from_model(dense(
        params['out'], out.reshape(b, q_len, num_heads * head_dim), dtype),
        mesh)

  logits = torch.einsum('bqhd,bkhd->bhqk', query, key).to(torch.float32)
  if bias is not None:
    logits = logits + bias.to(torch.float32)
  weights = torch.softmax(logits, dim=-1).to(dtype)
  if dropout:
    weights = weights * mult
  out = torch.einsum('bhqk,bkhd->bqhd', weights, value)
  return partitioning.reduce_from_model(dense(
      params['out'], out.reshape(b, q_len, num_heads * head_dim), dtype),
      mesh)


@dataclasses.dataclass
class KVCache:
  """Decoder self-attention cache [layers, batch, kv_heads, head_dim, length].

  Quantized caches hold int8 codes, or int4 codes packed two per uint8
  ([layers, batch, kv_heads, head_dim / 2, length]), with float32 scales
  key_scale/value_scale [layers, batch, kv_heads, length].
  """
  key: torch.Tensor
  value: torch.Tensor
  key_scale: Optional[torch.Tensor] = None
  value_scale: Optional[torch.Tensor] = None

  @property
  def quantized(self) -> bool:
    return self.key_scale is not None


def init_kv_cache(num_layers: int, batch: int, num_heads: int, head_dim: int,
                  max_len: int, dtype=torch.float32, device='cpu',
                  quantized: bool = False, bits: int = 8) -> KVCache:
  """Zeroed caches of the full length; the port never grows them."""
  def zeros(shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=device)

  if not quantized:
    shape = (num_layers, batch, num_heads, head_dim, max_len)
    return KVCache(key=zeros(shape, dtype), value=zeros(shape, dtype))
  if bits == 4:
    if head_dim % 2:
      raise ValueError(f'int4 caches pack head_dim in pairs, got {head_dim}')
    shape, qdtype = (num_layers, batch, num_heads, head_dim // 2,
                     max_len), torch.uint8
  else:
    shape, qdtype = (num_layers, batch, num_heads, head_dim,
                     max_len), torch.int8
  scale_shape = (num_layers, batch, num_heads, max_len)
  return KVCache(key=zeros(shape, qdtype), value=zeros(shape, qdtype),
                 key_scale=zeros(scale_shape, torch.float32),
                 value_scale=zeros(scale_shape, torch.float32))


def _quantize_kv(x: torch.Tensor, bits: int = 8):
  """Symmetric per-vector quantization of [..., d] (layers._quantize_kv):
  (int8 codes [..., d], unpacked for int4, and float32 scales [...])."""
  return decode_attention.quantize_kv(x, bits)


def quantize_kv_sequence(x: torch.Tensor):
  """Symmetric per-(..., position) int8 quantization of [..., d, len]
  (layers.quantize_kv_sequence): (int8 codes, float32 scales [..., len]),
  in the steps of _quantize_kv."""
  return decode_attention.quantize_sequence(x)


def _int8dot_attention(query: torch.Tensor, cache_k: torch.Tensor,
                       cache_v: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor, cache_index: torch.Tensor,
                       dtype) -> torch.Tensor:
  """The 'xla_int8dot' branch of layers._cached_attention_math (:506-519),
  one query head per K/V head: the query and weights*v_scale quantized to
  int8, integer products accumulated exactly (in float64: torch has no
  integer matmul on CUDA, and every sum here is an integer below 2**53),
  scaled in float32.  query [b, h, d] -> [b, h, d] in `dtype`."""
  max_len = cache_k.shape[-1]
  codes_k = decode_attention.cache_codes(cache_k).to(torch.float64)
  codes_v = decode_attention.cache_codes(cache_v).to(torch.float64)
  q_q, q_scale = decode_attention.quantize_kv(query.to(torch.float32))
  logits = torch.einsum('bhd,bhdl->bhl', q_q.to(torch.float64), codes_k)
  logits = logits.to(torch.float32) * (q_scale[..., None] * k_scale)
  visible = torch.arange(max_len, device=cache_k.device) <= (
      cache_index.reshape(()))
  logits = torch.where(visible, logits, torch.full_like(logits, NEG_INF))
  weights = torch.softmax(logits, dim=-1)
  wv_q, wv_scale = decode_attention.quantize_kv(weights * v_scale)
  out = torch.einsum('bhl,bhdl->bhd', wv_q.to(torch.float64), codes_v)
  return (out.to(torch.float32) * wv_scale[..., None]).to(dtype)


def attention_decode_step(
    params: Params, x: torch.Tensor, cache_k: torch.Tensor,
    cache_v: torch.Tensor, cache_index: torch.Tensor, num_heads: int,
    head_dim: int, dtype=torch.float32, cache_update: str = 'dus',
    attention_impl: str = 'xla',
    cache_k_scale: Optional[torch.Tensor] = None,
    cache_v_scale: Optional[torch.Tensor] = None,
    num_kv_heads: Optional[int] = None, mesh: Optional[Mesh] = None):
  """Single-position self-attention against one layer's [b,kv,d,len] cache.

  x [b, emb]; cache_index an int32 tensor on x's device.  Writes the new
  K/V column at cache_index into the caches IN PLACE (quantized, with its
  scales, when scales are given) and returns (out [b, emb], cache_k,
  cache_v), plus (cache_k_scale, cache_v_scale) for quantized caches, as
  the JAX function returns them.

  attention_impl 'xla' and 'pallas_v3' take the decode-attention kernel
  (ops/decode_attention.py) on a CUDA tensor and its plain version on a
  CPU tensor; 'xla_int8dot' needs a quantized cache and, with one query
  head per K/V head, is plain torch (_int8dot_attention), else it is the
  grouped quantized branch, as in the JAX package.  cache_update 'dus' and
  'onehot' both write one column in place.  With a mesh the caches hold
  the rank's K/V heads (partitioning.head_layout).
  """
  layout = partitioning.head_layout(num_heads, num_kv_heads, head_dim, mesh)
  num_heads, kv_heads = layout.heads, layout.kv_heads
  group = num_heads // kv_heads
  quantized = cache_k_scale is not None
  if attention_impl not in ('xla', 'xla_int8dot', 'pallas_v3'):
    raise ValueError(f'unknown attention_impl: {attention_impl!r}')
  if cache_update not in ('dus', 'onehot'):
    raise ValueError(f'unknown cache_update: {cache_update!r}')
  if attention_impl == 'xla_int8dot' and not quantized:
    raise ValueError(
        "decode_attention_impl='xla_int8dot' requires decode_kv_quantize")
  if attention_impl.startswith('pallas') and quantized:
    raise ValueError(
        'pallas decode kernels do not support quantized caches; '
        'use the xla implementations with decode_kv_quantize')
  if attention_impl == 'pallas_v3' and group != 1:
    raise NotImplementedError('pallas decode kernels are MHA-only')
  b = x.shape[0]
  x = partitioning.copy_to_model(x, mesh)
  key_kernel, value_kernel = _kv_kernels(params, layout, mesh)
  query = dense(params['query'], x, dtype).reshape(b, num_heads, head_dim)
  key = dense(key_kernel, x, dtype).reshape(b, kv_heads, head_dim)
  value = dense(value_kernel, x, dtype).reshape(b, kv_heads, head_dim)
  if attention_impl == 'xla_int8dot' and group == 1:
    decode_attention.write_column(key, value, cache_k, cache_v, cache_index,
                                  cache_k_scale, cache_v_scale)
    out = _int8dot_attention(query, cache_k, cache_v, cache_k_scale,
                             cache_v_scale, cache_index, dtype)
  else:
    out = decode_attention.decode_attention_inplace(
        query, key, value, cache_k, cache_v, cache_index, cache_k_scale,
        cache_v_scale)
  out = partitioning.reduce_from_model(
      dense(params['out'], out.reshape(b, num_heads * head_dim), dtype), mesh)
  if quantized:
    return out, cache_k, cache_v, cache_k_scale, cache_v_scale
  return out, cache_k, cache_v


def check_stacked_impl(attention_impl: str):
  """The JAX package's check of decode_cache_carry='stacked'."""
  if attention_impl not in ('xla', 'xla_int8dot'):
    raise ValueError(
        f"decode_cache_carry='stacked' supports attention_impl 'xla' / "
        f"'xla_int8dot', not {attention_impl!r}")


def self_attention_decode_stacked(
    params: Params, x: torch.Tensor, cache: KVCache, layer: int,
    cache_index: torch.Tensor, num_heads: int, head_dim: int,
    dtype=torch.float32, attention_impl: str = 'xla',
    num_kv_heads: Optional[int] = None, mesh: Optional[Mesh] = None):
  """Decode-step self-attention writing into the stacked [L, ...] cache.

  layers.self_attention_decode_stacked writes one column into the full
  stacked cache instead of carrying per-layer slices; the port's caches
  are written in place either way, so this is attention_decode_step on
  layer `layer`'s views, after check_stacked_impl.  Returns
  (out [b, emb], cache).
  """
  check_stacked_impl(attention_impl)
  scales = ((cache.key_scale[layer], cache.value_scale[layer])
            if cache.quantized else (None, None))
  out = attention_decode_step(
      params, x, cache.key[layer], cache.value[layer], cache_index,
      num_heads, head_dim, dtype=dtype, attention_impl=attention_impl,
      cache_k_scale=scales[0], cache_v_scale=scales[1],
      num_kv_heads=num_kv_heads, mesh=mesh)[0]
  return out, cache


def cross_attention_decode_step(
    params: Params, x: torch.Tensor, keys: torch.Tensor,
    values: torch.Tensor, num_heads: int, head_dim: int,
    dtype=torch.float32, num_kv_heads: Optional[int] = None,
    key_scale: Optional[torch.Tensor] = None,
    value_scale: Optional[torch.Tensor] = None,
    mesh: Optional[Mesh] = None) -> torch.Tensor:
  """Single-position cross-attention over projected encoder K/V.

  x [b, emb]; keys/values [b, kv, d, enc_len], projected once per segment;
  with key_scale/value_scale [b, kv, enc_len] they are int8 codes and the
  scales fold into the products, as in layers.cross_attention_decode_step.
  Torch einsums, as XLA computes them in the JAX package.  With a mesh,
  keys/values hold the rank's K/V heads.
  """
  b = x.shape[0]
  layout = partitioning.head_layout(num_heads, num_kv_heads, head_dim, mesh)
  num_heads, kv_heads = layout.heads, layout.kv_heads
  group = num_heads // kv_heads
  x = partitioning.copy_to_model(x, mesh)
  query = dense(params['query'], x, dtype).reshape(
      b, kv_heads, group, head_dim)
  logits = torch.einsum('bkgd,bkde->bkge', query,
                        keys.to(dtype)).to(torch.float32)
  if key_scale is not None:
    logits = logits * key_scale[:, :, None, :]
  weights = torch.softmax(logits, dim=-1).to(dtype)
  if value_scale is not None:
    weights = (weights.to(torch.float32)
               * value_scale[:, :, None, :]).to(dtype)
  out = torch.einsum('bkge,bkde->bkgd', weights, values.to(dtype))
  return partitioning.reduce_from_model(
      dense(params['out'], out.reshape(b, num_heads * head_dim), dtype), mesh)


# ---------------------------------------------------------------------------
# Mask / bias construction: additive biases, 0 where attendable and -1e10
# where masked.
# ---------------------------------------------------------------------------
NEG_INF = -1e10


def make_attention_bias(query_mask: torch.Tensor, key_mask: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
  """[b, q] x [b, k] boolean-ish masks -> additive bias [b, 1, q, k]."""
  mask = query_mask[:, :, None] * key_mask[:, None, :]
  bias = torch.where(mask > 0, 0.0, NEG_INF).to(dtype)
  return bias[:, None, :, :]


def make_causal_bias(length: int, dtype=torch.float32,
                     device='cpu') -> torch.Tensor:
  """Additive causal bias [1, 1, q, k]."""
  idx = torch.arange(length, device=device)
  mask = idx[:, None] >= idx[None, :]
  bias = torch.where(mask, 0.0, NEG_INF).to(dtype)
  return bias[None, None, :, :]


def make_decoder_bias(decoder_target_tokens: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
  """Causal + padding bias: i may attend to j iff j <= i, both non-padding."""
  length = decoder_target_tokens.shape[-1]
  causal = make_causal_bias(length, dtype, decoder_target_tokens.device)
  nonpad = (decoder_target_tokens > 0).to(dtype)
  padding = make_attention_bias(nonpad, nonpad, dtype)
  return torch.clamp(causal + padding, min=NEG_INF)
