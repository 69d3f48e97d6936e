"""Neural-net building blocks (PyTorch port of mt3_tpu/models/layers.py).

Plain functions of (parameter dict, tensors), as in the JAX package:

  * Dense kernels are stored 2-D [in_features, out_features] like t5x
    DenseGeneral, so the JAX parameter tree converts with no transposes
    (see mt3_tpu_torch/params.py).
  * Matmuls cast to a compute dtype (bfloat16 when served) while parameters
    and norm statistics stay float32.  Float32 products run in true float32:
    the port never turns TF32 on (the JAX package asks for HIGHEST precision,
    layers.matmul_precision).
  * Decode caches are [layers, batch, heads, head_dim, length], the JAX
    layout, and are updated in place: a decode step writes one column.

Ported here: full attention with training-time dropout and the flash route
(kernel C, ops/flash_attention.py), and the MHA, unquantized decode path
with cache_update 'dus'.  The quantized, grouped-query, 'onehot' and
'xla_int8dot' decode modes raise NotImplementedError until their
ROADMAP.md items land.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mt3_tpu_torch.ops import decode_attention, flash_attention

Params = Dict[str, torch.Tensor]

_QUANTIZED = ('quantized decode caches are not ported yet '
              '(ROADMAP.md, modules to port: production decode variants)')
_GQA = ('grouped-query decode is not ported yet '
        '(ROADMAP.md, modules to port: production decode variants)')


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
              dtype=torch.float32) -> torch.Tensor:
  """gelu(x @ wi_0) * (x @ wi_1) @ wo for activations ('gelu', 'linear')."""
  h = None
  for idx, act_name in enumerate(activations):
    name = 'wi' if len(activations) == 1 else f'wi_{idx}'
    a = _activation(act_name)(dense(params[name], x, dtype))
    h = a if h is None else h * a
  return dense(params['wo'], h, dtype)


def embed(table: torch.Tensor, ids: torch.Tensor,
          dtype=torch.float32) -> torch.Tensor:
  """Token embedding lookup as a one-hot contraction, as the JAX package does."""
  one_hot_ids = F.one_hot(ids.to(torch.long), table.shape[0]).to(dtype)
  return torch.matmul(one_hot_ids, table.to(dtype))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def dropout_keep(generator: torch.Generator, shape, rate: float,
                 device) -> torch.Tensor:
  """Boolean keep mask, True with probability 1 - rate (uniform < 1 - rate,
  as jax.random.bernoulli draws it)."""
  return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def attention(params: Params, inputs_q: torch.Tensor,
              inputs_kv: torch.Tensor, bias: Optional[torch.Tensor],
              num_heads: int, head_dim: int, dtype=torch.float32,
              dropout_generator: Optional[torch.Generator] = None,
              dropout_rate: float = 0.0,
              num_kv_heads: Optional[int] = None,
              flash_mode: Optional[str] = None) -> torch.Tensor:
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
  """
  b, q_len, _ = inputs_q.shape
  k_len = inputs_kv.shape[1]
  kv_heads = num_kv_heads or num_heads
  query = dense(params['query'], inputs_q, dtype).reshape(
      b, q_len, num_heads, head_dim)
  key = dense(params['key'], inputs_kv, dtype).reshape(
      b, k_len, kv_heads, head_dim)
  value = dense(params['value'], inputs_kv, dtype).reshape(
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
                        dropout_rate, inputs_q.device)
    mult = keep.to(dtype) / torch.tensor(1.0 - dropout_rate, dtype=dtype)

  if flash_mode is not None and min(q_len, k_len) >= 128:
    if dropout:
      value = value * mult.permute(0, 3, 1, 2)  # [b, k, h, 1]
    out = flash_attention.flash_attention(
        query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
        causal=(flash_mode == 'causal'), sm_scale=1.0)
    out = out.transpose(1, 2).to(dtype)
    return dense(params['out'], out.reshape(b, q_len, num_heads * head_dim),
                 dtype)

  logits = torch.einsum('bqhd,bkhd->bhqk', query, key).to(torch.float32)
  if bias is not None:
    logits = logits + bias.to(torch.float32)
  weights = torch.softmax(logits, dim=-1).to(dtype)
  if dropout:
    weights = weights * mult
  out = torch.einsum('bhqk,bkhd->bqhd', weights, value)
  return dense(params['out'], out.reshape(b, q_len, num_heads * head_dim),
               dtype)


@dataclasses.dataclass
class KVCache:
  """Decoder self-attention cache [layers, batch, heads, head_dim, length]."""
  key: torch.Tensor
  value: torch.Tensor


def init_kv_cache(num_layers: int, batch: int, num_heads: int, head_dim: int,
                  max_len: int, dtype=torch.float32, device='cpu',
                  quantized: bool = False) -> KVCache:
  """Zeroed caches of the full length; the port never grows them."""
  if quantized:
    raise NotImplementedError(_QUANTIZED)
  shape = (num_layers, batch, num_heads, head_dim, max_len)
  return KVCache(key=torch.zeros(shape, dtype=dtype, device=device),
                 value=torch.zeros(shape, dtype=dtype, device=device))


def attention_decode_step(
    params: Params, x: torch.Tensor, cache_k: torch.Tensor,
    cache_v: torch.Tensor, cache_index: torch.Tensor, num_heads: int,
    head_dim: int, dtype=torch.float32, cache_update: str = 'dus',
    attention_impl: str = 'xla',
    cache_k_scale: Optional[torch.Tensor] = None,
    cache_v_scale: Optional[torch.Tensor] = None,
    num_kv_heads: Optional[int] = None):
  """Single-position self-attention against one layer's [b,h,d,len] cache.

  x [b, emb]; cache_index an int32 tensor on x's device.  Writes the new
  K/V column at cache_index into cache_k/cache_v IN PLACE and returns
  (out [b, emb], cache_k, cache_v).

  attention_impl 'xla' and 'pallas_v3' name two TPU implementations of one
  function, so both take the same route here: the decode-attention kernel
  (ops/decode_attention.py) on a CUDA tensor, its plain version on a CPU
  tensor.
  """
  if cache_k_scale is not None or cache_v_scale is not None:
    raise NotImplementedError(_QUANTIZED)
  if (num_kv_heads or num_heads) != num_heads:
    raise NotImplementedError(_GQA)
  if cache_update != 'dus':
    raise NotImplementedError(
        f"cache_update={cache_update!r} is not ported yet (ROADMAP.md, "
        "modules to port: production decode variants); 'dus' is")
  if attention_impl == 'xla_int8dot':
    raise NotImplementedError(_QUANTIZED)
  if attention_impl not in ('xla', 'pallas_v3'):
    raise ValueError(f'unknown attention_impl: {attention_impl!r}')
  b = x.shape[0]
  query = dense(params['query'], x, dtype).reshape(b, num_heads, head_dim)
  key = dense(params['key'], x, dtype).reshape(b, num_heads, head_dim)
  value = dense(params['value'], x, dtype).reshape(b, num_heads, head_dim)
  out = decode_attention.decode_attention_inplace(
      query, key, value, cache_k, cache_v, cache_index)
  out = dense(params['out'], out.reshape(b, num_heads * head_dim), dtype)
  return out, cache_k, cache_v


def cross_attention_decode_step(
    params: Params, x: torch.Tensor, keys: torch.Tensor,
    values: torch.Tensor, num_heads: int, head_dim: int,
    dtype=torch.float32, num_kv_heads: Optional[int] = None,
    key_scale: Optional[torch.Tensor] = None,
    value_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Single-position cross-attention over projected encoder K/V.

  x [b, emb]; keys/values [b, h, d, enc_len], projected once per segment.
  """
  if key_scale is not None or value_scale is not None:
    raise NotImplementedError(_QUANTIZED)
  if (num_kv_heads or num_heads) != num_heads:
    raise NotImplementedError(_GQA)
  b = x.shape[0]
  query = dense(params['query'], x, dtype).reshape(b, num_heads, head_dim)
  logits = torch.einsum('bhd,bhdk->bhk', query,
                        keys.to(dtype)).to(torch.float32)
  weights = torch.softmax(logits, dim=-1).to(dtype)
  out = torch.einsum('bhk,bhdk->bhd', weights, values.to(dtype))
  return dense(params['out'], out.reshape(b, num_heads * head_dim), dtype)


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
