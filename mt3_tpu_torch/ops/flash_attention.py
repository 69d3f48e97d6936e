"""Blockwise (flash) attention for training: CUDA kernels and plain version.

`flash_attention(q, k, v, causal, sm_scale)` is the port of the stock
Pallas TPU kernel the JAX package trains with
(jax.experimental.pallas.ops.tpu.flash_attention.flash_attention, called
at mt3_tpu/models/layers.py:230-243).  q is [b, h, lq, d], k and v
[b, h, lk, d]; it returns softmax(q k^T * sm_scale [+ causal mask]) v in
q's dtype.

On a CUDA tensor it is a torch.autograd.Function over csrc/flash_attention.cu:
the forward kernel saves the float32 row log-sum-exp, and the backward
launches the dK/dV kernel and then the dQ kernel.  On a CPU tensor it runs
`flash_attention_plain`, whose backward comes from autograd.  Any other
device raises.

LAUNCHES counts kernel launches per entry point ('fwd', 'dkv', 'dq') and
nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from mt3_tpu_torch.ops import cuda_build

# The stock kernel's DEFAULT_MASK_VALUE, added to masked scores.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# csrc/flash_attention.cu instantiations: mt3's and ismir2021's head dim.
HEAD_DIMS = (64,)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {'fwd': 0, 'dkv': 0, 'dq': 0}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, sm_scale: float = 1.0) -> torch.Tensor:
  """The kernel's function in plain torch: float32 scores, the stock mask
  constant, p cast to v's dtype before p v, output in q's dtype."""
  s = torch.matmul(q.to(torch.float32),
                   k.to(torch.float32).transpose(-1, -2))
  if sm_scale != 1.0:
    s = s * sm_scale
  if causal:
    rows = torch.arange(q.shape[-2], device=q.device)[:, None]
    cols = torch.arange(k.shape[-2], device=q.device)[None, :]
    s = s + torch.where(cols <= rows, 0.0, MASK_VALUE)
  m = s.amax(dim=-1, keepdim=True)
  p = torch.exp(s - m)
  l = p.sum(dim=-1, keepdim=True)
  o = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))
  return (o / l).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, sm_scale: float = 1.0) -> torch.Tensor:
  """[b, h, lq, d] x [b, h, lk, d] x [b, h, lk, d] -> [b, h, lq, d]."""
  if q.device.type == 'cpu':
    return flash_attention_plain(q, k, v, causal, sm_scale)
  _check(q, k, v)
  return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))


def _check(q, k, v):
  for name, t in (('q', q), ('k', k), ('v', v)):
    if not t.is_cuda:
      raise ValueError(f'flash attention kernel needs CUDA tensors, {name} '
                       f'is on {t.device}')
    if t.device != q.device:
      raise ValueError(f'{name} is on {t.device}, q on {q.device}')
    if t.dtype != q.dtype:
      raise ValueError(f'{name} is {t.dtype}, q is {q.dtype}: the kernel '
                       'takes one dtype')
    if t.dim() != 4:
      raise ValueError(f'{name} must be [b, h, len, d], got {tuple(t.shape)}')
  if q.dtype not in _DTYPES:
    raise ValueError(f'flash attention kernel takes float32 or bfloat16, '
                     f'got {q.dtype}')
  if k.shape != v.shape or k.shape[:2] != q.shape[:2] or (
      k.shape[-1] != q.shape[-1]):
    raise ValueError(f'shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v '
                     f'{tuple(v.shape)} do not match')
  if q.shape[-1] not in HEAD_DIMS:
    raise ValueError(f'head_dim {q.shape[-1]} is not one of {HEAD_DIMS}')
  if min(q.shape[2], k.shape[2], q.shape[0] * q.shape[1]) == 0:
    raise ValueError('flash attention kernel needs non-empty inputs')


class _FlashAttention(torch.autograd.Function):
  """Forward and backward kernels; the backward is not differentiable."""

  @staticmethod
  def forward(ctx, q, k, v, causal, sm_scale):
    q, k, v = (t.contiguous() for t in (q, k, v))
    o, lse = _launch_fwd(q, k, v, causal, sm_scale)
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.sm_scale = causal, sm_scale
    return o

  @staticmethod
  def backward(ctx, grad_out):
    q, k, v, o, lse = ctx.saved_tensors
    grad_out = grad_out.to(q.dtype).contiguous()
    # di = rowsum(o * dO) in float32, outside the kernels as in the stock
    # backward (flash_attention.py:274).
    di = (o.to(torch.float32) * grad_out.to(torch.float32)).sum(-1)
    dk, dv = _launch_dkv(q, k, v, grad_out, lse, di, ctx.causal,
                         ctx.sm_scale)
    dq = _launch_dq(q, k, v, grad_out, lse, di, ctx.causal, ctx.sm_scale)
    return dq, dk, dv, None, None


def _dims(q, k):
  b, h, lq, d = q.shape
  return b * h, lq, k.shape[2], d


def _stream(t):
  return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(q, k, v, causal, sm_scale):
  bh, lq, lk, d = _dims(q, k)
  o = torch.empty_like(q)
  lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
  lib = _library()
  status = lib.mt3_flash_attention_fwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
      bh, lq, lk, d, int(causal), sm_scale, _DTYPES[q.dtype], _stream(q))
  cuda_build.check(lib, status, 'flash_attention_fwd')
  LAUNCHES['fwd'] += 1
  return o, lse


def _launch_dkv(q, k, v, grad_out, lse, di, causal, sm_scale):
  bh, lq, lk, d = _dims(q, k)
  dk = torch.empty_like(k)
  dv = torch.empty_like(v)
  lib = _library()
  status = lib.mt3_flash_attention_dkv(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(),
      lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
      bh, lq, lk, d, int(causal), sm_scale, _DTYPES[q.dtype], _stream(q))
  cuda_build.check(lib, status, 'flash_attention_dkv')
  LAUNCHES['dkv'] += 1
  return dk, dv


def _launch_dq(q, k, v, grad_out, lse, di, causal, sm_scale):
  bh, lq, lk, d = _dims(q, k)
  dq = torch.empty_like(q)
  lib = _library()
  status = lib.mt3_flash_attention_dq(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(),
      lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
      bh, lq, lk, d, int(causal), sm_scale, _DTYPES[q.dtype], _stream(q))
  cuda_build.check(lib, status, 'flash_attention_dq')
  LAUNCHES['dq'] += 1
  return dq


def _library() -> ctypes.CDLL:
  lib = cuda_build.library('flash_attention')
  if lib.mt3_flash_attention_fwd.argtypes is None:
    shape = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.mt3_flash_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + shape
    lib.mt3_flash_attention_dkv.argtypes = [ctypes.c_void_p] * 8 + shape
    lib.mt3_flash_attention_dq.argtypes = [ctypes.c_void_p] * 7 + shape
    for fn in (lib.mt3_flash_attention_fwd, lib.mt3_flash_attention_dkv,
               lib.mt3_flash_attention_dq):
      fn.restype = ctypes.c_int
  return lib
