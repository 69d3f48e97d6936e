"""T5's RMS norm (models/layers.rms_norm): the CUDA kernel and its plain
version.

`rms_norm(scale, x, epsilon, dtype)` normalises the last dimension of x
with float32 statistics and scales it:

  rstd = rsqrt(mean(x^2) + epsilon)
  y    = to_dtype(to_dtype(x * rstd) * to_dtype(scale))

On a CUDA tensor it launches csrc/rms_norm.cu (kernel D): one pass a row,
x read once and y written in x's dtype, float32 or bfloat16 (the port
norms its residual stream in the activation dtype), with the float32
scale parameter.  Where autograd needs a gradient it runs as a
torch.autograd.Function whose forward also writes a float32 rstd a row
and whose backward is a kernel too: dx in x's dtype and dscale in
float32, reduced without atomics.  Elsewhere (no grad,
the decode step's CUDA-graph capture) the forward alone runs.  On a CPU
tensor it runs `rms_norm_plain`, the composition of PyTorch ops that the
port ran before the kernel.  Any other device raises.

The kernel replaces no Pallas kernel: the JAX package leaves the norm to
XLA's fusion, where PyTorch runs nine kernels over the activations with
float32 intermediates, and about as many again in the backward.  It was
added because those kernels moved most of the bf16 train step's
elementwise bytes; bytes bound it (4 an element forward and 6 backward in
bf16).

Its launches are counted under 'rms_norm_fwd' and 'rms_norm_bwd' (one for
the backward's two kernels, the second of which sums dscale) in
ops.launch_counts(); the counter norm.kernel_calls (utils/profiling)
counts the calls that take the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from mt3_tpu_torch.ops import cuda_build
from mt3_tpu_torch.utils import profiling

# dtype -> the kernel's dtype code (csrc/rms_norm.cu kFloat32, kBfloat16).
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel loads 8 elements a lane; a warp takes rows of up to 1024.
WIDTH_MULTIPLE = 8
MAX_WIDTH = 1024


def rms_norm_plain(scale: torch.Tensor, x: torch.Tensor,
                   epsilon: float = 1e-6,
                   dtype=torch.float32) -> torch.Tensor:
  """T5 LayerNorm: RMS only, no mean subtraction, float32 statistics."""
  x = x.to(torch.float32)
  mean2 = torch.mean(x * x, dim=-1, keepdim=True)
  y = (x * torch.rsqrt(mean2 + epsilon)).to(dtype)
  return y * scale.to(dtype)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, epsilon: float = 1e-6,
             dtype=torch.float32) -> torch.Tensor:
  """[..., d] -> [..., d] in dtype; scale [d]."""
  if x.device.type == 'cpu':
    return rms_norm_plain(scale, x, epsilon, dtype)
  _check(scale, x, dtype)
  profiling.count('norm.kernel_calls')
  if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
    return _RMSNorm.apply(scale, x, float(epsilon))
  return _launch_fwd(scale, x, float(epsilon), with_rstd=False)[0]


def _check(scale, x, dtype):
  if not x.is_cuda:
    raise ValueError(f'rms_norm kernel needs a CUDA tensor, got {x.device}')
  if scale.device != x.device:
    raise ValueError(f'scale is on {scale.device}, x on {x.device}')
  if x.dtype not in DTYPES or dtype != x.dtype:
    raise ValueError(f'rms_norm kernel takes float32 or bfloat16 x and '
                     f'writes y in its dtype: x is {x.dtype}, dtype {dtype}')
  if scale.dtype != torch.float32:
    raise ValueError(f'rms_norm kernel takes the float32 scale parameter, '
                     f'got {scale.dtype}')
  d = x.shape[-1] if x.dim() else 0
  if x.numel() == 0 or d % WIDTH_MULTIPLE or d > MAX_WIDTH:
    raise ValueError(f'rms_norm kernel takes non-empty rows of a multiple of '
                     f'{WIDTH_MULTIPLE} up to {MAX_WIDTH}, got shape '
                     f'{tuple(x.shape)}')
  if tuple(scale.shape) != (d,):
    raise ValueError(f'scale {tuple(scale.shape)} is not [{d}]')
  for name, t in (('x', x), ('scale', scale)):
    if not t.is_contiguous() or t.data_ptr() % 16:
      raise ValueError(f'rms_norm kernel needs {name} contiguous and 16-byte '
                       f'aligned (strides {t.stride()})')


class _RMSNorm(torch.autograd.Function):
  """Forward and backward kernels; the backward is not differentiable."""

  @staticmethod
  def forward(ctx, scale, x, epsilon):
    y, rstd = _launch_fwd(scale, x, epsilon, with_rstd=True)
    ctx.save_for_backward(scale, x, rstd)
    return y

  @staticmethod
  def backward(ctx, dy):
    scale, x, rstd = ctx.saved_tensors
    dx, dscale = _launch_bwd(scale, x, dy, rstd,
                             with_dscale=ctx.needs_input_grad[0])
    return dscale, dx, None


def _launch_fwd(scale, x, epsilon, with_rstd):
  """(y in x's dtype, float32 rstd [rows] or None)."""
  d = x.shape[-1]
  rows = x.numel() // d
  y = torch.empty_like(x)
  rstd = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
          if with_rstd else None)
  lib = _library()
  status = lib.mt3_rms_norm_fwd(
      x.data_ptr(), scale.data_ptr(), y.data_ptr(),
      None if rstd is None else rstd.data_ptr(), rows, d, epsilon,
      DTYPES[x.dtype], _stream(x))
  cuda_build.launched(lib, status, 'rms_norm_fwd')
  return y, rstd


def _launch_bwd(scale, x, dy, rstd, with_dscale):
  """(dx in x's dtype, float32 dscale [d] or None)."""
  d = x.shape[-1]
  rows = x.numel() // d
  dy = dy.to(x.dtype)
  if not dy.is_contiguous() or dy.data_ptr() % 16:
    dy = dy.clone(memory_format=torch.contiguous_format)   # e.g. an expand
  lib = _library()
  blocks = ctypes.c_int(0)
  status = lib.mt3_rms_norm_bwd_blocks(rows, d, DTYPES[x.dtype],
                                       ctypes.byref(blocks))
  cuda_build.check(lib, status, 'rms_norm_bwd_blocks')
  dx = torch.empty_like(x)
  partial = dscale = None
  if with_dscale:
    partial = torch.empty((blocks.value, d), dtype=torch.float32,
                          device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
  status = lib.mt3_rms_norm_bwd(
      x.data_ptr(), dy.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
      dx.data_ptr(), None if partial is None else partial.data_ptr(),
      None if dscale is None else dscale.data_ptr(), rows, d, blocks.value,
      DTYPES[x.dtype], _stream(x))
  cuda_build.launched(lib, status, 'rms_norm_bwd')
  return dx, dscale


def _stream(t):
  return torch.cuda.current_stream(t.device).cuda_stream


def _library() -> ctypes.CDLL:
  lib = cuda_build.library('rms_norm')
  if lib.mt3_rms_norm_fwd.argtypes is None:
    lib.mt3_rms_norm_fwd.argtypes = ([ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 2 + [ctypes.c_float]
                                     + [ctypes.c_int, ctypes.c_void_p])
    lib.mt3_rms_norm_fwd.restype = ctypes.c_int
    lib.mt3_rms_norm_bwd_blocks.argtypes = ([ctypes.c_int] * 3
                                            + [ctypes.POINTER(ctypes.c_int)])
    lib.mt3_rms_norm_bwd_blocks.restype = ctypes.c_int
    lib.mt3_rms_norm_bwd.argtypes = ([ctypes.c_void_p] * 7
                                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.mt3_rms_norm_bwd.restype = ctypes.c_int
  return lib
