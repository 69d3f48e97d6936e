"""Fused log-mel spectrogram: the CUDA kernel and its plain version.

`logmel_fused` is the port of the Pallas TPU kernel
mt3_tpu/ops/pallas/logmel.py:logmel_fused.  On a CUDA tensor it launches
csrc/logmel.cu (framing, window, packed real FFT, magnitude, banded mel
product and safe log in one kernel); on a CPU tensor it runs `logmel_plain`,
the plain matmul path of ops/spectrogram.  Any other device raises.

The kernel reads its constants from `kernel_tables`, built once per device
with numpy: the window, the FFT's twiddles (float64, stored in float32) and
each mel filter as a band (first bin, count, weights taken bit for bit from
spectrogram._mel_matrix).

Its launches are counted under 'logmel' in ops.launch_counts().
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from mt3_tpu_torch.core.config import SpectrogramConfig
from mt3_tpu_torch.ops import cuda_build
from mt3_tpu_torch.ops import spectrogram as spec_lib

FFT_SIZE = 2048   # csrc/logmel.cu kFft: the kernel's FFT is 32 x 32 complex


class KernelTables(NamedTuple):
  window: torch.Tensor     # [fft] float32: periodic Hann
  twiddles: torch.Tensor   # [16 + 1024 + 1025, 2] float32 (re, im)
  bands: torch.Tensor      # [num_mel, 2] int32: first bin, bin count
  weights: torch.Tensor    # [max count, num_mel] float32, zero past a count


_TABLES: Dict[Tuple[str, SpectrogramConfig], KernelTables] = {}


def logmel_plain(samples: torch.Tensor, config: SpectrogramConfig,
                 eps: float = 1e-5) -> torch.Tensor:
  """[..., n] -> [..., n // hop, mel_bins]: frame, DFT matmuls, |.|, mel, log."""
  magnitude = spec_lib.stft_magnitude(samples, config)
  mel = torch.from_numpy(spec_lib._mel_matrix(config)).to(magnitude.device)
  return spec_lib.safe_log(torch.matmul(magnitude, mel), eps)


def twiddle_table() -> np.ndarray:
  """[2065, 2] float32 (re, im), in csrc/logmel.cu's order: W_32^k for
  k < 16; W_1024^(b c) at row 16 + 32 c + b; e^(-2 pi i k / 2048) for
  k <= 1024.  W_N = e^(-2 pi i / N), computed in float64."""
  k32 = np.arange(16) / 32
  c, b = np.meshgrid(np.arange(32), np.arange(32), indexing='ij')
  step = (b * c).reshape(-1) / 1024
  split = np.arange(1025) / 2048
  angle = -2.0 * np.pi * np.concatenate([k32, step, split])
  return np.stack([np.cos(angle), np.sin(angle)], axis=-1).astype(np.float32)


def mel_bands(config: SpectrogramConfig) -> Tuple[np.ndarray, np.ndarray]:
  """Each filter of _mel_matrix as one contiguous band of DFT bins.

  Returns (bands [num_mel, 2] int32: first bin and count, weights
  [max count, num_mel] float32: weights[t, m] = mel[first + t, m]); an
  empty filter has count 0.
  """
  mel = spec_lib._mel_matrix(config)
  bands = np.zeros((mel.shape[1], 2), np.int32)
  for m in range(mel.shape[1]):
    nonzero = np.flatnonzero(mel[:, m])
    if nonzero.size:
      bands[m] = nonzero[0], nonzero[-1] - nonzero[0] + 1
  weights = np.zeros((max(1, int(bands[:, 1].max())), mel.shape[1]),
                     np.float32)
  for m, (first, count) in enumerate(bands):
    weights[:count, m] = mel[first:first + count, m]
  return bands, weights


def kernel_tables(config: SpectrogramConfig,
                  device: torch.device) -> KernelTables:
  """The kernel's constant tables on `device`, built once per device."""
  key = (str(device), config)
  if key not in _TABLES:
    bands, weights = mel_bands(config)
    arrays = (spec_lib.hann_window(config.fft_size).astype(np.float32),
              twiddle_table(), bands, weights)
    _TABLES[key] = KernelTables(*(torch.from_numpy(a).to(device)
                                  for a in arrays))
  return _TABLES[key]


def logmel_fused(samples: torch.Tensor, config: SpectrogramConfig,
                 eps: float = 1e-5) -> torch.Tensor:
  """[..., n] samples -> [..., n // hop, mel_bins] log-mel."""
  if samples.device.type == 'cpu':
    return logmel_plain(samples, config, eps)
  return _launch(samples, config, eps)


def _launch(samples: torch.Tensor, config: SpectrogramConfig,
            eps: float) -> torch.Tensor:
  if not samples.is_cuda:
    raise ValueError(f'logmel kernel needs a CUDA tensor, got {samples.device}')
  if samples.dtype != torch.float32:
    raise ValueError(f'logmel kernel takes float32 audio, got {samples.dtype}')
  if not samples.is_contiguous():
    raise ValueError('logmel kernel needs contiguous audio')
  if samples.data_ptr() % 16 != 0:
    raise ValueError('logmel kernel needs 16-byte aligned audio')
  if samples.dim() < 1 or samples.shape[-1] == 0:
    raise ValueError(f'bad audio shape {tuple(samples.shape)}')
  hop, fft = config.hop_width, config.fft_size
  n = samples.shape[-1]
  if n % hop != 0 or fft % hop != 0 or hop % 4 != 0:
    raise ValueError('sample count and fft size must be multiples of the '
                     'hop, and the hop of 4')
  if fft != FFT_SIZE:
    raise ValueError(f'logmel kernel computes a {FFT_SIZE}-point FFT, config '
                     f'asks for {fft}')
  batch_shape = samples.shape[:-1]
  batch = int(np.prod(batch_shape, dtype=np.int64))
  num_mel = config.num_mel_bins
  tables = kernel_tables(config, samples.device)
  out = torch.empty(batch_shape + (n // hop, num_mel), dtype=torch.float32,
                    device=samples.device)
  # log(eps) rounded once, so that silence gives it exactly.
  log_eps = float(np.float32(np.log(np.float64(np.float32(eps)))))
  lib = _library()
  status = lib.mt3_logmel(
      samples.data_ptr(), tables.window.data_ptr(),
      tables.twiddles.data_ptr(), tables.bands.data_ptr(),
      tables.weights.data_ptr(), out.data_ptr(), batch, n, hop, fft, num_mel,
      log_eps, _stream(samples))
  cuda_build.launched(lib, status, 'logmel')
  return out


def _stream(t: torch.Tensor) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


def _library() -> ctypes.CDLL:
  lib = cuda_build.library('logmel')
  if lib.mt3_logmel.argtypes is None:
    lib.mt3_logmel.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                               + [ctypes.c_float, ctypes.c_void_p])
  return lib
