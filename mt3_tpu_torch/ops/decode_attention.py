"""Decode-step self-attention with in-place cache write: kernel and plain version.

`decode_attention_inplace` is the port of the Pallas TPU kernel
mt3_tpu/ops/pallas/decode_attention_v3.py:decode_attention_inplace, and of
the XLA branches of mt3_tpu/models/layers.py:_cached_attention_math that
read quantized or grouped caches.  It writes new_k/new_v into column
`index` of the caches (in place: the caches passed in are modified) and
returns

    out[b, h] = softmax_{j <= index}(q[b, h] . K[b, h // g, :, j])
                . V[b, h // g, :, j]                               [b, h, d]

for query [b, h, d], new_k/new_v [b, kv, d] and g = h / kv query heads
per K/V head (g = 1 is multi-head attention).  The caches are one of

  * float32 or bfloat16 [b, kv, d, len], in the query's dtype;
  * int8 codes [b, kv, d, len] with float32 scales [b, kv, len];
  * int4 codes packed two per uint8 along head_dim, [b, kv, d / 2, len]
    (row r: dim 2r in the low nibble, dim 2r + 1 in the high one, two's
    complement), with the same scales.

With scales, the new column is quantized as the JAX package's _quantize_kv
does (absmax over d in the query's dtype, `quantize_kv` below) and the
dequantisation folds into the products: logit_j = (q . codes_j) * k_scale_j,
and the weight p_j * v_scale_j meets the V codes.

On a CUDA tensor it launches csrc/decode_attention.cu: the multi-head
float kernel for float caches with g = 1, a grouped kernel for every other
cache (one block per (batch, K/V head, span) for all g query heads,
quantizing the new column itself): for bf16 queries at head dim 64 the
tensor-core kernel, else the float32 FMA kernel.  A combination neither
kernel takes raises.  On a CPU tensor it runs the plain version
(`decode_attention_plain`, `decode_attention_quantized_plain`).  Any other
device raises.  `index` is an int32 tensor on the caches' device, which
the kernels read themselves.

The multi-head kernel splits the cache length into L_SPLIT-position
pieces, one block each.  The grouped kernels give each block `span`
positions of one (batch, K/V head), picked by `grouped_split` from b * kv
and the cache length (static shapes, never `index`): the whole length where
b * kv fills the card, L_SPLIT where it does not.  Where a row has several
blocks they merge their partial softmax states in the same launch: each
call gets a float32 scratch tensor for the partials, and a per-device int32
counter buffer (zeroed once, left at zero by every call) finds the block
that merges.  Calls on one device therefore share that buffer and must come
from one stream, as the decode loop makes them; a CUDA graph of a call may
be replayed with a changed `index`.  A grouped call with one block per row
gets no partials and touches no counter.

LAUNCHES counts kernel launches and nothing else; VARIANT_LAUNCHES counts
them by cache variant (`variant`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from mt3_tpu_torch.ops import cuda_build

NEG_INF = -1e10   # the XLA path's mask constant (mt3_tpu layers.NEG_INF)
# csrc/decode_attention.cu instantiations: tiny_config's 8 and mt3's 64.
HEAD_DIMS = (8, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The grouped kernel's cache kinds (csrc/decode_attention.cu CacheKind).
_CACHE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.uint8: 3}
MAX_GROUP = 8  # csrc/decode_attention.cu kMaxGroup: query heads per K/V head
L_SPLIT = 64   # csrc/decode_attention.cu kSplit: cache positions per block
# The grouped kernels' blocks (one per (batch, K/V head) and span) that fill
# an H100: 132 SMs with about 8 resident blocks each.  At b * kv >= this a
# block takes the whole cache length.
GROUPED_BLOCKS = 1024
# One counter per (batch, K/V head) block row, up to the grid's 65535 rows,
# allocated once: a captured graph keeps the buffer it was captured with.
_COUNTERS_PER_DEVICE = 65535

LAUNCHES = 0
VARIANT_LAUNCHES: Dict[str, int] = {}

_COUNTERS: Dict[torch.device, torch.Tensor] = {}


# ---------------------------------------------------------------------------
# Quantization (mt3_tpu/models/layers.py:_quantize_kv) and the int4 layout.
# ---------------------------------------------------------------------------
def quantize_kv(x: torch.Tensor, bits: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-vector quantization of x [..., d] over its last axis.

  Returns (codes int8 [..., d], scale float32 [...]).  127 levels for
  int8, 7 for int4 (codes in [-8, 7], unpacked).  The steps are those XLA
  compiles _quantize_kv to under jit, as the JAX package's decode step
  runs it: the scale max|x| / levels becomes max|x| times the float32
  reciprocal of levels, rounded to x's dtype; the 1e-8 floor, x / scale (a
  division) and the rounding (half to even) are in x's dtype; the scale is
  cast to float32 last, and the cast to the integer type saturates.
  """
  levels, low, high = (7, -8, 7) if bits == 4 else (127, -128, 127)
  return _quantize(x, -1, levels, low, high)


def _quantize(x: torch.Tensor, dim: int, levels: int, low: int, high: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Codes and float32 scales of x over axis `dim` (see quantize_kv)."""
  amax = x.abs().amax(dim=dim, keepdim=True)
  # Scalars, not device tensors, so that a CUDA graph can capture it.
  scale = (amax.to(torch.float32) * (1.0 / levels)).to(x.dtype)
  scale = scale.clamp_min(1e-8)
  codes = torch.round(x / scale).clamp(low, high)
  return codes.to(torch.int8), scale.squeeze(dim).to(torch.float32)


def quantize_sequence(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """int8 codes and float32 scales of x [..., d, len] over d, per position
  (layers.quantize_kv_sequence), in the steps of quantize_kv."""
  return _quantize(x, -2, 127, -128, 127)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
  """int8 codes in [-8, 7], [..., d, n] -> uint8 [..., d / 2, n]: row r
  holds dim 2r in its low nibble and dim 2r + 1 in its high nibble."""
  nibbles = codes.to(torch.int32) & 15
  return (nibbles[..., 0::2, :] | (nibbles[..., 1::2, :] << 4)).to(
      torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
  """uint8 [..., d / 2, n] -> int8 codes [..., d, n] (inverse of pack_int4)."""
  p = packed.to(torch.int32)
  low, high = p & 15, p >> 4
  low = low - ((low >= 8).to(torch.int32) << 4)
  high = high - ((high >= 8).to(torch.int32) << 4)
  codes = torch.stack([low, high], dim=-2)        # [..., d / 2, 2, n]
  return codes.flatten(-3, -2).to(torch.int8)


def cache_codes(cache: torch.Tensor) -> torch.Tensor:
  """A quantized cache's codes as int8 [..., d, len] (int4 unpacked)."""
  return unpack_int4(cache) if cache.dtype == torch.uint8 else cache


def grouped_split(rows: int, length: int) -> Tuple[int, int]:
  """(span, splits) of the grouped kernels for b * kv = `rows` and a cache
  of `length` positions: span, a multiple of L_SPLIT, positions per block,
  and splits = ceil(length / span) blocks per (batch, K/V head), about
  GROUPED_BLOCKS / rows of them (one at rows > GROUPED_BLOCKS / 2), so
  that rows * splits comes near GROUPED_BLOCKS and never passes it with
  more than one split."""
  tiles = -(-length // L_SPLIT)
  wanted = max(1, min(tiles, GROUPED_BLOCKS // rows))
  span = -(-tiles // wanted) * L_SPLIT
  return span, -(-length // span)


def variant(cache_k: torch.Tensor, group: int) -> str:
  """The kernel variant's name for a cache dtype and query heads per K/V
  head: 'mha', 'gqa', 'int8', 'int4', 'int8_gqa' or 'int4_gqa'."""
  quant = {torch.int8: 'int8', torch.uint8: 'int4'}.get(cache_k.dtype)
  if quant is None:
    return 'mha' if group == 1 else 'gqa'
  return quant if group == 1 else f'{quant}_gqa'


# ---------------------------------------------------------------------------
# Plain versions: the column write, then the masked softmax over the whole
# cache, with the casts of layers._cached_attention_math.
# ---------------------------------------------------------------------------
def _column(index: torch.Tensor, length: int) -> torch.Tensor:
  """The write index clamped to [0, len - 1], as dynamic_update_slice."""
  return index.reshape(1).to(torch.long).clamp(0, length - 1)


def write_column(new_k: torch.Tensor, new_v: torch.Tensor,
                 cache_k: torch.Tensor, cache_v: torch.Tensor,
                 index: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> None:
  """Write new_k/new_v [b, kv, d] into column `index`, in place; with
  scales, quantized as attention_decode_step quantizes them."""
  length = cache_k.shape[-1]
  column = _column(index, length)
  if k_scale is None:
    cache_k.index_copy_(-1, column, new_k.unsqueeze(-1).to(cache_k.dtype))
    cache_v.index_copy_(-1, column, new_v.unsqueeze(-1).to(cache_v.dtype))
    return
  bits = 4 if cache_k.dtype == torch.uint8 else 8
  for new, cache, scales in ((new_k, cache_k, k_scale),
                             (new_v, cache_v, v_scale)):
    codes, scale = quantize_kv(new, bits)
    codes = codes.unsqueeze(-1)
    cache.index_copy_(-1, column, pack_int4(codes) if bits == 4 else codes)
    scales.index_copy_(-1, column, scale.unsqueeze(-1))


def attention_plain(query: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, index: torch.Tensor,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Masked attention over a written cache; query [b, h, d] -> [b, h, d].

  The four XLA branches of layers._cached_attention_math (:520-560) in
  one: query [b, kv, g, d] against the cache in the query's dtype, logits
  then float32 (times k_scale when quantized), softmax in float32, the
  weights (times v_scale) back in the query's dtype.  g = 1 is the MHA
  branch.
  """
  b, h, d = query.shape
  kv = cache_k.shape[1]
  dtype = query.dtype
  max_len = cache_k.shape[-1]
  if k_scale is not None:
    cache_k, cache_v = cache_codes(cache_k), cache_codes(cache_v)
  q = query.reshape(b, kv, h // kv, d)
  logits = torch.einsum('bkgd,bkdl->bkgl', q,
                        cache_k.to(dtype)).to(torch.float32)
  if k_scale is not None:
    logits = logits * k_scale[:, :, None, :]
  visible = torch.arange(max_len, device=cache_k.device) <= index.reshape(())
  logits = torch.where(visible, logits, torch.full_like(logits, NEG_INF))
  weights = torch.softmax(logits, dim=-1)
  if v_scale is not None:
    weights = weights * v_scale[:, :, None, :]
  out = torch.einsum('bkgl,bkdl->bkgd', weights.to(dtype), cache_v.to(dtype))
  return out.reshape(b, h, d)


def decode_attention_plain(query: torch.Tensor, new_k: torch.Tensor,
                           new_v: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor,
                           index: torch.Tensor) -> torch.Tensor:
  """Write then masked softmax over a whole float [b, kv, d, len] cache.

  The same arithmetic and casts as the JAX package's XLA decode path
  (layers._cached_attention_math, MHA and grouped branches): logits in the
  query's dtype then float32, softmax in float32, weights back in the
  query's dtype.  The write index is clamped to [0, len - 1] like
  dynamic_update_slice.
  """
  write_column(new_k, new_v, cache_k, cache_v, index)
  return attention_plain(query, cache_k, cache_v, index)


def decode_attention_quantized_plain(
    query: torch.Tensor, new_k: torch.Tensor, new_v: torch.Tensor,
    cache_k: torch.Tensor, cache_v: torch.Tensor, index: torch.Tensor,
    k_scale: torch.Tensor, v_scale: torch.Tensor) -> torch.Tensor:
  """Quantized write then masked softmax over a whole int8 or packed int4
  cache (layers._cached_attention_math, quantized MHA and grouped
  branches, :520-540)."""
  write_column(new_k, new_v, cache_k, cache_v, index, k_scale, v_scale)
  return attention_plain(query, cache_k, cache_v, index, k_scale, v_scale)


def decode_attention_inplace(query: torch.Tensor, new_k: torch.Tensor,
                             new_v: torch.Tensor, cache_k: torch.Tensor,
                             cache_v: torch.Tensor, index: torch.Tensor,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
  """Fused cache write + attention; returns out [b, h, d] in query's dtype."""
  if (k_scale is None) != (v_scale is None):
    raise ValueError('pass both k_scale and v_scale, or neither')
  if query.device.type == 'cpu':
    if k_scale is None:
      return decode_attention_plain(query, new_k, new_v, cache_k, cache_v,
                                    index)
    return decode_attention_quantized_plain(query, new_k, new_v, cache_k,
                                            cache_v, index, k_scale, v_scale)
  return _launch(query, new_k, new_v, cache_k, cache_v, index, k_scale,
                 v_scale)


# ---------------------------------------------------------------------------
# The kernels.
# ---------------------------------------------------------------------------
def _check_tensors(tensors: Dict[str, torch.Tensor],
                   device: torch.device) -> None:
  for name, t in tensors.items():
    if not t.is_cuda:
      raise ValueError(
          f'decode attention kernel needs CUDA tensors, {name} is on '
          f'{t.device}')
    if t.device != device:
      raise ValueError(f'{name} is on {t.device}, query on {device}')
    if not t.is_contiguous():
      raise ValueError(f'decode attention kernel needs contiguous {name}')


def _launch(query, new_k, new_v, cache_k, cache_v, index, k_scale=None,
            v_scale=None) -> torch.Tensor:
  global LAUNCHES
  tensors = dict(query=query, new_k=new_k, new_v=new_v, cache_k=cache_k,
                 cache_v=cache_v, index=index)
  if k_scale is not None:
    tensors.update(k_scale=k_scale, v_scale=v_scale)
  _check_tensors(tensors, query.device)
  if query.dtype not in _DTYPES:
    raise ValueError(f'decode attention kernel takes float32 or bfloat16, '
                     f'got {query.dtype}')
  for name in ('new_k', 'new_v'):
    if tensors[name].dtype != query.dtype:
      raise ValueError(f'{name} is {tensors[name].dtype}, query is '
                       f'{query.dtype}: the kernel takes one dtype')
  if index.dtype != torch.int32 or index.numel() != 1:
    raise ValueError('index must be one int32 element on the device')
  if query.dim() != 3 or new_k.dim() != 3:
    raise ValueError(f'query and new_k must be [b, h, d] and [b, kv, d], '
                     f'got {tuple(query.shape)}, {tuple(new_k.shape)}')
  b, h, d = query.shape
  kv = new_k.shape[1]
  if (new_k.shape[0] != b or new_k.shape[2] != d
      or new_v.shape != new_k.shape):
    raise ValueError(f'new_k/new_v must be [b, kv, d] = [{b}, kv, {d}], '
                     f'got {tuple(new_k.shape)}, {tuple(new_v.shape)}')
  if d not in HEAD_DIMS:
    raise ValueError(f'head_dim {d} is not one of {HEAD_DIMS}')
  if h % kv or h // kv > MAX_GROUP:
    raise ValueError(f'{h} query heads over {kv} K/V heads: the kernel '
                     f'takes 1 to {MAX_GROUP} query heads per K/V head')
  group = h // kv
  quantized = k_scale is not None
  if quantized:
    if cache_k.dtype not in (torch.int8, torch.uint8):
      raise ValueError(f'scaled caches are int8 or packed int4 (uint8), '
                       f'got {cache_k.dtype}')
    rows = d // 2 if cache_k.dtype == torch.uint8 else d
  else:
    if cache_k.dtype != query.dtype:
      raise ValueError(f'cache_k is {cache_k.dtype}, query is {query.dtype}:'
                       ' float caches take the query dtype (int8 and int4 '
                       'caches come with scales)')
    rows = d
  if (cache_k.dim() != 4 or cache_k.shape[:3] != (b, kv, rows)
      or cache_v.shape != cache_k.shape or cache_v.dtype != cache_k.dtype):
    raise ValueError(f'caches must be {cache_k.dtype} [b, kv, rows, len] = '
                     f'[{b}, {kv}, {rows}, len], got {tuple(cache_k.shape)} '
                     f'{cache_k.dtype}, {tuple(cache_v.shape)} '
                     f'{cache_v.dtype}')
  length = cache_k.shape[-1]
  if quantized:
    for name, s in (('k_scale', k_scale), ('v_scale', v_scale)):
      if s.dtype != torch.float32 or s.shape != (b, kv, length):
        raise ValueError(f'{name} must be float32 [{b}, {kv}, {length}], '
                         f'got {s.dtype} {tuple(s.shape)}')
  if b * kv > _COUNTERS_PER_DEVICE:
    raise ValueError(f'b * kv = {b * kv} exceeds the kernel grid\'s '
                     f'{_COUNTERS_PER_DEVICE} rows')
  out = torch.empty_like(query)
  lib = _library()
  if group == 1 and not quantized:
    splits = -(-length // L_SPLIT)
    partials, counters = _workspace(query, splits)
    status = lib.mt3_decode_attention(
        query.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), index.data_ptr(),
        out.data_ptr(), partials.data_ptr(), counters.data_ptr(), b * h, d,
        length, splits, _DTYPES[query.dtype], _stream(query))
  else:
    span, splits = grouped_split(b * kv, length)
    partials, counters = _workspace(query, splits, grouped=True)
    status = lib.mt3_decode_attention_grouped(
        query.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None, index.data_ptr(),
        out.data_ptr(),
        partials.data_ptr() if partials is not None else None,
        counters.data_ptr(), b * kv, group, d, length, span, splits,
        _DTYPES[query.dtype], _CACHE_KINDS[cache_k.dtype], _stream(query))
  cuda_build.check(lib, status, 'decode_attention')
  LAUNCHES += 1
  name = variant(cache_k, group)
  VARIANT_LAUNCHES[name] = VARIANT_LAUNCHES.get(name, 0) + 1
  return out


def reset_launches() -> None:
  global LAUNCHES
  LAUNCHES = 0
  VARIANT_LAUNCHES.clear()


def _workspace(query: torch.Tensor, splits: int, grouped: bool = False
               ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
  """The kernel's scratch for one call of `splits` blocks per row:
  partials [b*h, splits, d + 2] float32 (none for a grouped call with one
  split, which merges nothing), and the device's counter buffer (int32)."""
  b, h, d = query.shape
  partials = None
  if not grouped or splits > 1:
    partials = torch.empty(b * h, splits, d + 2, dtype=torch.float32,
                           device=query.device)
  counters = _COUNTERS.get(query.device)
  if counters is None:
    counters = torch.zeros(_COUNTERS_PER_DEVICE, dtype=torch.int32,
                           device=query.device)
    _COUNTERS[query.device] = counters
  return partials, counters


def _stream(t: torch.Tensor) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


def _library() -> ctypes.CDLL:
  lib = cuda_build.library('decode_attention')
  if lib.mt3_decode_attention.argtypes is None:
    lib.mt3_decode_attention.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.mt3_decode_attention_grouped.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
  return lib
