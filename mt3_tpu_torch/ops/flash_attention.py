"""Blockwise (flash) attention for training: CUDA kernels and plain version.

`flash_attention(q, k, v, causal, sm_scale)` is the port of the stock
Pallas TPU kernel the JAX package trains with
(jax.experimental.pallas.ops.tpu.flash_attention.flash_attention, called
at mt3_tpu/models/layers.py:230-243).  q is [b, h, lq, d], k and v
[b, h, lk, d]; it returns softmax(q k^T * sm_scale [+ causal mask]) v in
q's dtype.

On a CUDA tensor it is a torch.autograd.Function over the kernels: bfloat16
runs the tensor-core kernels of csrc/flash_attention_tc.cu, float32 the
FMA kernels of csrc/flash_attention.cu.  The forward kernel saves the
float32 row log-sum-exp; the backward launches the dQ kernel, which also
writes di = rowsum(o * dO), and then the dK/dV kernel.  The kernels take
each tensor's batch, head and row strides, so q, k and v may be any views
with a unit last stride (layers.attention passes [b, len, h, d]
activations transposed), and the outputs come back in their inputs'
layouts.  On a CPU tensor it runs `flash_attention_plain`, whose backward
comes from autograd.  Any other device raises.

LAUNCHES counts kernel launches per entry point ('fwd', 'dkv', 'dq') and
nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from mt3_tpu_torch.ops import cuda_build

# The stock kernel's DEFAULT_MASK_VALUE, added to masked scores.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# The kernels' head dim: mt3's and ismir2021's.
HEAD_DIMS = (64,)
# dtype -> (source in csrc/, prefix of its entry points).
ROUTES = {torch.float32: ('flash_attention', 'mt3_flash_fma'),
          torch.bfloat16: ('flash_attention_tc', 'mt3_flash_tc')}

LAUNCHES = {'fwd': 0, 'dkv': 0, 'dq': 0}


class _Strides(ctypes.Structure):
  _fields_ = [('batch', ctypes.c_int64), ('head', ctypes.c_int64),
              ('row', ctypes.c_int64)]


_TENSORS = ('q', 'k', 'v', 'o', 'dout', 'dq', 'dk', 'dv')


class FlashArgs(ctypes.Structure):
  """csrc/flash_attention.cuh's FlashArgs, field for field."""
  _fields_ = ([(name, ctypes.c_void_p) for name in _TENSORS + ('lse', 'di')]
              + [(f'{name}_st', _Strides) for name in _TENSORS]
              + [(name, ctypes.c_int) for name in
                 ('batch', 'heads', 'lq', 'lk', 'head_dim', 'causal')]
              + [('sm_scale', ctypes.c_float)])


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
  if q.dtype not in ROUTES:
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
  for name, t in (('q', q), ('k', k), ('v', v)):
    if not _fits(t):
      raise ValueError(
          f'{name} (strides {t.stride()}) needs a unit last-dim stride'
          + (' and rows on 16-byte boundaries' if t.dtype == torch.bfloat16
             else ''))


def _fits(t: torch.Tensor) -> bool:
  """Whether the kernels take t as it lies: a unit last stride and, for
  the tensor-core kernels' 16-byte copies, 16-byte aligned rows."""
  if t.stride(-1) != 1:
    return False
  if t.dtype != torch.bfloat16:
    return True
  step = 16 // t.element_size()
  return t.data_ptr() % 16 == 0 and all(
      stride % step == 0 for size, stride in zip(t.shape[:3], t.stride()[:3])
      if size > 1)


class _FlashAttention(torch.autograd.Function):
  """Forward and backward kernels; the backward is not differentiable."""

  @staticmethod
  def forward(ctx, q, k, v, causal, sm_scale):
    o, lse = _launch_fwd(q, k, v, causal, sm_scale)
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.sm_scale = causal, sm_scale
    return o

  @staticmethod
  def backward(ctx, grad_out):
    q, k, v, o, lse = ctx.saved_tensors
    grad_out = grad_out.to(q.dtype)
    if not _fits(grad_out):   # e.g. the expanded gradient of a sum()
      grad_out = grad_out.clone(memory_format=torch.contiguous_format)
    dq, di = _launch_dq(q, k, v, o, grad_out, lse, ctx.causal, ctx.sm_scale)
    dk, dv = _launch_dkv(q, k, v, grad_out, lse, di, ctx.causal,
                         ctx.sm_scale)
    return dq, dk, dv, None, None


def _launch(which, q, k, v, causal, sm_scale, **tensors):
  """Fills FlashArgs from the tensors (outputs allocated by the caller) and
  launches entry point `which` for q's dtype."""
  b, h, lq, d = q.shape
  args = FlashArgs(batch=b, heads=h, lq=lq, lk=k.shape[2], head_dim=d,
                   causal=int(causal), sm_scale=sm_scale)
  for name, t in dict(q=q, k=k, v=v, **tensors).items():
    setattr(args, name, t.data_ptr())
    if name not in ('lse', 'di'):
      setattr(args, f'{name}_st', _Strides(*t.stride()[:3]))
  lib, entry = _entry(q.dtype, which)
  status = entry(ctypes.byref(args), _stream(q))
  cuda_build.check(lib, status, f'flash_attention_{which}')
  LAUNCHES[which] += 1


def _rows(q):
  return torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)


def _launch_fwd(q, k, v, causal, sm_scale):
  """o in q's layout, and the float32 row log-sum-exp [b, h, lq]."""
  o, lse = torch.empty_like(q), _rows(q)
  _launch('fwd', q, k, v, causal, sm_scale, o=o, lse=lse)
  return o, lse


def _launch_dq(q, k, v, o, grad_out, lse, causal, sm_scale):
  """dq in q's layout, and di = rowsum(o * dO) in float32 [b, h, lq]."""
  dq, di = torch.empty_like(q), _rows(q)
  _launch('dq', q, k, v, causal, sm_scale, o=o, dout=grad_out, lse=lse,
          di=di, dq=dq)
  return dq, di


def _launch_dkv(q, k, v, grad_out, lse, di, causal, sm_scale):
  """dk and dv in k's and v's layouts."""
  dk, dv = torch.empty_like(k), torch.empty_like(v)
  _launch('dkv', q, k, v, causal, sm_scale, dout=grad_out, lse=lse, di=di,
          dk=dk, dv=dv)
  return dk, dv


def _stream(t):
  return torch.cuda.current_stream(t.device).cuda_stream


def _entry(dtype, which):
  """(library, entry point) of `which` for dtype."""
  source, prefix = ROUTES[dtype]
  lib = cuda_build.library(source)
  entry = getattr(lib, f'{prefix}_{which}')
  if entry.argtypes is None:
    entry.argtypes = [ctypes.POINTER(FlashArgs), ctypes.c_void_p]
    entry.restype = ctypes.c_int
  return lib, entry
