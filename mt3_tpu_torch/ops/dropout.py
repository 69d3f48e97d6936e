"""Dropout and the residual add after it (models/t5._dropout): the CUDA
kernel and its plain version.

`dropout_add(h, keep, rate, residual=None)` applies a boolean keep mask to
h, scaled by 1 / (1 - rate), and adds the residual where one is given:

  y = [residual +] where(keep, h / to_dtype(1 - rate), 0)

keep is h's shape or h's with a length (dim -2) of 1, broadcast along the
length as T5's dropout draws it (reference broadcast_dims=(-2,)).

On a CUDA tensor it launches csrc/dropout_add.cu (kernel E): one pass over
the activations, residual and h read and y written in h's dtype, float32
or bfloat16, the broadcast mask read as it is.  Where autograd needs a
gradient it runs as a torch.autograd.Function that saves only the mask
and whose backward is the same kernel without a residual,
dh = where(keep, dy / to_dtype(1 - rate), 0); the residual's gradient is
dy itself.  Elsewhere (no grad) the forward alone runs.  Kernel and plain
version round at the same steps, so they agree to the bit.  On a CPU
tensor it runs `dropout_add_plain`, the composition of PyTorch ops that
the port ran before the kernel.  Any other device raises.

The kernel replaces no Pallas kernel: the JAX package leaves dropout to
XLA's fusion, where PyTorch runs three kernels over the activations (the
division, the `where`, the add) and two more in the backward.  It was
added because, once kernel D had taken the norm's, those kernels were the
bf16 train step's largest elementwise cost; bytes bound it (6 an element
forward with a residual, 4 without and 4 backward, in bf16).

Its launches are counted under 'dropout_add_fwd' and 'dropout_add_bwd' in
ops.launch_counts(); the counter dropout.kernel_calls (utils/profiling)
counts the calls that take the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mt3_tpu_torch.ops import cuda_build
from mt3_tpu_torch.utils import profiling

# dtype -> the kernel's dtype code (csrc/dropout_add.cu kFloat32, kBfloat16).
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel indexes elements with 31 bits.
MAX_ELEMENTS = 2**31 - 1


def dropout_add_plain(h: torch.Tensor, keep: torch.Tensor, rate: float,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
  """[residual +] h where keep, scaled by 1 / (1 - rate), else 0."""
  out = torch.where(keep, h / torch.tensor(1.0 - rate, dtype=h.dtype),
                    torch.zeros((), dtype=h.dtype, device=h.device))
  return out if residual is None else residual + out


def dropout_add(h: torch.Tensor, keep: torch.Tensor, rate: float,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
  """h [..., length, d] and keep [..., length or 1, d] -> y in h's dtype."""
  if h.device.type == 'cpu':
    return dropout_add_plain(h, keep, rate, residual)
  _check(h, keep, residual)
  profiling.count('dropout.kernel_calls')
  keep = keep.contiguous()   # a mesh rank's mask is a slice of the global one
  inv = _inverse_keep(rate, h.dtype)
  if torch.is_grad_enabled() and (h.requires_grad or (
      residual is not None and residual.requires_grad)):
    return _DropoutAdd.apply(h, keep, inv, residual)
  return _launch(h, keep, inv, residual, 'dropout_add_fwd')


def _inverse_keep(rate: float, dtype) -> float:
  """1 / to_dtype(1 - rate) in float32, as PyTorch's division by a CPU
  scalar tensor computes it (a product with the reciprocal)."""
  keep = torch.tensor(1.0 - rate, dtype=dtype).to(torch.float32)
  return float(torch.tensor(1.0, dtype=torch.float32) / keep)


def _check(h, keep, residual):
  if not h.is_cuda:
    raise ValueError(f'dropout_add kernel needs a CUDA tensor, got {h.device}')
  if h.dtype not in DTYPES:
    raise ValueError(f'dropout_add kernel takes float32 or bfloat16 h, got '
                     f'{h.dtype}')
  if keep.dtype != torch.bool or keep.device != h.device:
    raise ValueError(f'dropout_add kernel takes a bool mask on {h.device}, '
                     f'got {keep.dtype} on {keep.device}')
  shape = tuple(h.shape)
  broadcast = shape[:-2] + (1,) + shape[-1:] if h.dim() >= 2 else None
  if tuple(keep.shape) not in (shape, broadcast):
    raise ValueError(f'dropout_add kernel takes a mask of h\'s shape {shape} '
                     f'or {broadcast}, got {tuple(keep.shape)}')
  if not 0 < h.numel() <= MAX_ELEMENTS:
    raise ValueError(f'dropout_add kernel takes 1 to {MAX_ELEMENTS} '
                     f'elements, got shape {shape}')
  if residual is not None and (residual.device != h.device
                               or residual.dtype != h.dtype
                               or tuple(residual.shape) != shape):
    raise ValueError(f'the residual ({residual.dtype} {tuple(residual.shape)} '
                     f'on {residual.device}) is not h\'s ({h.dtype} {shape} '
                     f'on {h.device})')
  for name, t in (('h', h), ('residual', residual)):
    if t is not None and not t.is_contiguous():
      raise ValueError(f'dropout_add kernel needs {name} contiguous '
                       f'(strides {t.stride()})')


class _DropoutAdd(torch.autograd.Function):
  """The kernel forward and backward; saves only the mask."""

  @staticmethod
  def forward(ctx, h, keep, inv, residual):
    ctx.save_for_backward(keep)
    ctx.inv, ctx.dtype = inv, h.dtype
    return _launch(h, keep, inv, residual, 'dropout_add_fwd')

  @staticmethod
  def backward(ctx, dy):
    (keep,) = ctx.saved_tensors
    dh = None
    if ctx.needs_input_grad[0]:
      # An expand, say, arrives with strides of 0.
      g = dy.to(ctx.dtype).contiguous()
      dh = _launch(g, keep, ctx.inv, None, 'dropout_add_bwd')
    return dh, None, None, dy if ctx.needs_input_grad[3] else None


def _launch(h, keep, inv, residual, name):
  """y = [residual +] (keep ? h * inv : 0) in h's dtype."""
  d = h.shape[-1]
  length = h.shape[-2] if keep.shape != h.shape else 1
  y = torch.empty_like(h, memory_format=torch.contiguous_format)
  lib = _library()
  status = lib.mt3_dropout_add(
      None if residual is None else residual.data_ptr(), h.data_ptr(),
      keep.data_ptr(), y.data_ptr(), h.numel(), d, length, inv,
      DTYPES[h.dtype], _stream(h))
  cuda_build.launched(lib, status, name)
  return y


def _stream(t):
  return torch.cuda.current_stream(t.device).cuda_stream


def _library() -> ctypes.CDLL:
  lib = cuda_build.library('dropout_add')
  if lib.mt3_dropout_add.argtypes is None:
    lib.mt3_dropout_add.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_int64] + [ctypes.c_int] * 2
                                    + [ctypes.c_float, ctypes.c_int,
                                       ctypes.c_void_p])
    lib.mt3_dropout_add.restype = ctypes.c_int
  return lib
