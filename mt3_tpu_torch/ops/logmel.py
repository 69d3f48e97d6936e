"""Fused log-mel spectrogram: the CUDA kernel and its plain version.

`logmel_fused` is the port of the Pallas TPU kernel
mt3_tpu/ops/pallas/logmel.py:logmel_fused.  On a CUDA tensor it launches
csrc/logmel.cu (framing, windowed DFT, magnitude, mel projection and safe
log in one kernel); on a CPU tensor it runs `logmel_plain`, the plain
matmul path of ops/spectrogram.  Any other device raises.

LAUNCHES counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from mt3_tpu_torch.core.config import SpectrogramConfig
from mt3_tpu_torch.ops import cuda_build
from mt3_tpu_torch.ops import spectrogram as spec_lib

FREQ_TILE = 64   # csrc/logmel.cu kFreqTile: bases are padded to it
NUM_MEL = 512    # csrc/logmel.cu kMel

LAUNCHES = 0

_BASES: Dict[Tuple[str, SpectrogramConfig], Tuple[torch.Tensor, ...]] = {}


def logmel_plain(samples: torch.Tensor, config: SpectrogramConfig,
                 eps: float = 1e-5) -> torch.Tensor:
  """[..., n] -> [..., n // hop, mel_bins]: frame, DFT matmuls, |.|, mel, log."""
  magnitude = spec_lib.stft_magnitude(samples, config)
  mel = torch.from_numpy(spec_lib._mel_matrix(config)).to(magnitude.device)
  return spec_lib.safe_log(torch.matmul(magnitude, mel), eps)


def padded_bases(config: SpectrogramConfig, device: torch.device):
  """(cos, sin [fft, F], mel [F, mel_bins]) on `device`, F padded to 64.

  Built once per device from the same numpy bases as the plain path; the
  padded bins are zero in every matrix.
  """
  key = (str(device), config)
  if key not in _BASES:
    w_cos, w_sin = spec_lib._windowed_dft_matrices(config.fft_size,
                                                   config.fft_size)
    mel = spec_lib._mel_matrix(config)
    n_freq = w_cos.shape[1]
    pad = -n_freq % FREQ_TILE
    w_cos = np.pad(w_cos, [(0, 0), (0, pad)])
    w_sin = np.pad(w_sin, [(0, 0), (0, pad)])
    mel = np.pad(mel, [(0, pad), (0, 0)])
    _BASES[key] = tuple(
        torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(device)
        for m in (w_cos, w_sin, mel))
  return _BASES[key]


def logmel_fused(samples: torch.Tensor, config: SpectrogramConfig,
                 eps: float = 1e-5) -> torch.Tensor:
  """[..., n] samples -> [..., n // hop, mel_bins] log-mel."""
  if samples.device.type == 'cpu':
    return logmel_plain(samples, config, eps)
  return _launch(samples, config, eps)


def _launch(samples: torch.Tensor, config: SpectrogramConfig,
            eps: float) -> torch.Tensor:
  global LAUNCHES
  if not samples.is_cuda:
    raise ValueError(f'logmel kernel needs a CUDA tensor, got {samples.device}')
  if samples.dtype != torch.float32:
    raise ValueError(f'logmel kernel takes float32 audio, got {samples.dtype}')
  if not samples.is_contiguous():
    raise ValueError('logmel kernel needs contiguous audio')
  if samples.dim() < 1 or samples.shape[-1] == 0:
    raise ValueError(f'bad audio shape {tuple(samples.shape)}')
  hop, fft = config.hop_width, config.fft_size
  n = samples.shape[-1]
  if n % hop != 0 or fft % hop != 0:
    raise ValueError('sample count and fft size must be multiples of the hop')
  if config.num_mel_bins != NUM_MEL:
    raise ValueError(f'logmel kernel computes {NUM_MEL} mel bins, '
                     f'config asks for {config.num_mel_bins}')
  batch_shape = samples.shape[:-1]
  batch = int(np.prod(batch_shape, dtype=np.int64))
  w_cos, w_sin, mel = padded_bases(config, samples.device)
  out = torch.empty(batch_shape + (n // hop, NUM_MEL), dtype=torch.float32,
                    device=samples.device)
  lib = _library()
  status = lib.mt3_logmel(
      samples.data_ptr(), w_cos.data_ptr(), w_sin.data_ptr(), mel.data_ptr(),
      out.data_ptr(), batch, n, hop, fft, w_cos.shape[1], NUM_MEL, eps,
      torch.cuda.current_stream(samples.device).cuda_stream)
  cuda_build.check(lib, status, 'logmel')
  LAUNCHES += 1
  return out


def _library() -> ctypes.CDLL:
  lib = cuda_build.library('logmel')
  if lib.mt3_logmel.argtypes is None:
    lib.mt3_logmel.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                               + [ctypes.c_float, ctypes.c_void_p])
  return lib
