"""Decode-step self-attention with in-place cache write: kernel and plain version.

`decode_attention_inplace` is the port of the Pallas TPU kernel
mt3_tpu/ops/pallas/decode_attention_v3.py:decode_attention_inplace.  It
writes new_k/new_v into column `index` of the [b, h, d, len] caches (in
place: the caches passed in are modified) and returns

    out[b, h] = softmax_{j <= index}(q . K[:, j]) . V[:, j]    [b, h, d]

On a CUDA tensor it launches csrc/decode_attention.cu; on a CPU tensor it
runs `decode_attention_plain`.  Any other device raises.  `index` is an
int32 tensor on the caches' device, which the kernel reads itself.

The kernel splits the cache length into L_SPLIT-position pieces, one block
each, and merges their partial softmax states in the same launch.  Each
call gets a float32 scratch tensor for the partials; a per-device int32
counter buffer (zeroed once, left at zero by every call) finds the block
that merges.  Calls on one device therefore share that buffer and must come
from one stream, as the decode loop makes them; a CUDA graph of a call may
be replayed with a changed `index`.

LAUNCHES counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from mt3_tpu_torch.ops import cuda_build

NEG_INF = -1e10   # the XLA path's mask constant (mt3_tpu layers.NEG_INF)
# csrc/decode_attention.cu instantiations: tiny_config's 8 and mt3's 64.
HEAD_DIMS = (8, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
L_SPLIT = 64   # csrc/decode_attention.cu kSplit: cache positions per block
# Counters for up to this many (batch, head) pairs are allocated at once,
# so that the buffer a captured graph holds is not replaced by a larger one.
_MIN_COUNTERS = 4096

LAUNCHES = 0

_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def decode_attention_plain(query: torch.Tensor, new_k: torch.Tensor,
                           new_v: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor,
                           index: torch.Tensor) -> torch.Tensor:
  """Write then masked softmax over the whole [b, h, d, len] cache.

  The same arithmetic and casts as the JAX package's XLA decode path
  (layers._cached_attention_math, MHA branch): logits in the query's dtype
  then float32, softmax in float32, weights back in the query's dtype.
  The write index is clamped to [0, len - 1] like dynamic_update_slice.
  """
  max_len = cache_k.shape[-1]
  column = index.reshape(1).to(torch.long).clamp(0, max_len - 1)
  cache_k.index_copy_(-1, column, new_k.unsqueeze(-1).to(cache_k.dtype))
  cache_v.index_copy_(-1, column, new_v.unsqueeze(-1).to(cache_v.dtype))
  dtype = query.dtype
  logits = torch.einsum('bhd,bhdl->bhl', query,
                        cache_k.to(dtype)).to(torch.float32)
  visible = torch.arange(max_len, device=cache_k.device) <= index.reshape(())
  logits = torch.where(visible, logits, torch.full_like(logits, NEG_INF))
  weights = torch.softmax(logits, dim=-1).to(dtype)
  return torch.einsum('bhl,bhdl->bhd', weights, cache_v.to(dtype))


def decode_attention_inplace(query: torch.Tensor, new_k: torch.Tensor,
                             new_v: torch.Tensor, cache_k: torch.Tensor,
                             cache_v: torch.Tensor,
                             index: torch.Tensor) -> torch.Tensor:
  """Fused cache write + attention; returns out [b, h, d] in query's dtype."""
  if query.device.type == 'cpu':
    return decode_attention_plain(query, new_k, new_v, cache_k, cache_v,
                                  index)
  return _launch(query, new_k, new_v, cache_k, cache_v, index)


def _launch(query, new_k, new_v, cache_k, cache_v, index) -> torch.Tensor:
  global LAUNCHES
  tensors = dict(query=query, new_k=new_k, new_v=new_v, cache_k=cache_k,
                 cache_v=cache_v, index=index)
  for name, t in tensors.items():
    if not t.is_cuda:
      raise ValueError(
          f'decode attention kernel needs CUDA tensors, {name} is on '
          f'{t.device}')
    if t.device != query.device:
      raise ValueError(f'{name} is on {t.device}, query on {query.device}')
    if not t.is_contiguous():
      raise ValueError(f'decode attention kernel needs contiguous {name}')
  if query.dtype not in _DTYPES:
    raise ValueError(f'decode attention kernel takes float32 or bfloat16, '
                     f'got {query.dtype}')
  for name in ('new_k', 'new_v', 'cache_k', 'cache_v'):
    if tensors[name].dtype != query.dtype:
      raise ValueError(f'{name} is {tensors[name].dtype}, query is '
                       f'{query.dtype}: the kernel takes one dtype')
  if index.dtype != torch.int32 or index.numel() != 1:
    raise ValueError('index must be one int32 element on the device')
  if query.dim() != 3:
    raise ValueError(f'query must be [b, h, d], got {tuple(query.shape)}')
  b, h, d = query.shape
  if new_k.shape != query.shape or new_v.shape != query.shape:
    raise ValueError('new_k/new_v must match the query shape [b, h, d]')
  if (cache_k.dim() != 4 or cache_k.shape[:3] != (b, h, d)
      or cache_v.shape != cache_k.shape):
    raise ValueError(f'caches must be [b, h, d, len] = [{b}, {h}, {d}, len], '
                     f'got {tuple(cache_k.shape)}, {tuple(cache_v.shape)}')
  if d not in HEAD_DIMS:
    raise ValueError(f'head_dim {d} is not one of {HEAD_DIMS}')
  length = cache_k.shape[-1]
  out = torch.empty_like(query)
  partials, counters = _workspace(query, length)
  lib = _library()
  status = lib.mt3_decode_attention(
      query.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
      cache_k.data_ptr(), cache_v.data_ptr(), index.data_ptr(),
      out.data_ptr(), partials.data_ptr(), counters.data_ptr(), b * h, d,
      length, partials.shape[1], _DTYPES[query.dtype], _stream(query))
  cuda_build.check(lib, status, 'decode_attention')
  LAUNCHES += 1
  return out


def _workspace(query: torch.Tensor,
               length: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """The kernel's scratch for one call: partials [b*h, S, d + 2] float32,
  S = ceil(length / L_SPLIT), and the device's counter buffer (int32)."""
  b, h, d = query.shape
  splits = -(-length // L_SPLIT)
  partials = torch.empty(b * h, splits, d + 2, dtype=torch.float32,
                         device=query.device)
  counters = _COUNTERS.get(query.device)
  if counters is None or counters.numel() < b * h:
    counters = torch.zeros(max(b * h, _MIN_COUNTERS), dtype=torch.int32,
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
  return lib
