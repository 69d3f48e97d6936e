"""Log-mel spectrogram frontend (PyTorch port of mt3_tpu/ops/spectrogram.py).

The spectral frontend as matrix math, as in the JAX package:

    frame (strided row gather) -> windowed real DFT as two matmuls
    -> |.| -> mel projection matmul -> safe log

The bases are computed in numpy exactly as the JAX package computes them.
`compute_logmel` on a CUDA tensor runs the fused log-mel kernel
(ops/logmel.py, csrc/logmel.cu); on a CPU tensor it runs these plain
matmuls.  Float32 products run in true float32 (TF32 stays off).

Shapes: for n samples (a multiple of hop_width) the output has n // hop_width
frames, matching tf.signal.stft(pad_end=True).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mt3_tpu_torch.core.config import SpectrogramConfig
from mt3_tpu_torch.ops import mel


def hann_window(size: int) -> np.ndarray:
  """Periodic Hann window (tf.signal.hann_window default)."""
  return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(size) / size)).astype(
      np.float64)


@functools.lru_cache(maxsize=None)
def _windowed_dft_matrices(frame_size: int, fft_size: int):
  """Real-DFT basis with the Hann window folded in.

  Returns (cos, sin) float32 arrays [frame_size, fft_size // 2 + 1] such
  that for a frame x: re = x @ cos, im = x @ sin gives rfft(window * x).
  """
  n = np.arange(frame_size)[:, np.newaxis].astype(np.float64)
  k = np.arange(fft_size // 2 + 1)[np.newaxis, :].astype(np.float64)
  angle = 2.0 * np.pi * n * k / fft_size
  window = hann_window(frame_size)[:, np.newaxis]
  w_cos = (window * np.cos(angle)).astype(np.float32)
  w_sin = (-window * np.sin(angle)).astype(np.float32)
  return w_cos, w_sin


@functools.lru_cache(maxsize=None)
def _mel_matrix(config: SpectrogramConfig) -> np.ndarray:
  return mel.linear_to_mel_weight_matrix(
      num_mel_bins=config.num_mel_bins,
      num_spectrogram_bins=config.fft_size // 2 + 1,
      sample_rate=config.sample_rate,
      lower_edge_hertz=config.mel_lo_hz,
      upper_edge_hertz=config.mel_hi_hz)


def frame_signal(samples: torch.Tensor, frame_size: int,
                 hop: int) -> torch.Tensor:
  """Frame [..., n] samples into [..., n // hop, frame_size] windows.

  tf.signal.stft(pad_end=True) framing for n a multiple of hop: frame i
  covers samples [i*hop, i*hop + frame_size), zero-padded past the end.
  """
  if samples.shape[-1] % hop != 0:
    raise ValueError('sample count must be a multiple of the hop width')
  if frame_size % hop != 0:
    raise ValueError('frame_size must be a multiple of the hop width')
  padded = torch.nn.functional.pad(samples, (0, frame_size - hop))
  return padded.unfold(-1, frame_size, hop)


def stft_magnitude(samples: torch.Tensor,
                   config: SpectrogramConfig) -> torch.Tensor:
  """|STFT| of [..., n] samples -> [..., n // hop, fft_size // 2 + 1].

  The JAX package's 'matmul' method: the windowed real DFT as two matmuls.
  """
  frames = frame_signal(samples.to(torch.float32), config.fft_size,
                        config.hop_width)
  w_cos, w_sin = _windowed_dft_matrices(config.fft_size, config.fft_size)
  re = torch.matmul(frames, torch.from_numpy(w_cos).to(frames.device))
  im = torch.matmul(frames, torch.from_numpy(w_sin).to(frames.device))
  return torch.sqrt(re * re + im * im)


def safe_log(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
  """log(x) with non-positive values clamped to eps (spectral_ops.py:29-32)."""
  return torch.log(torch.where(x <= 0.0, torch.full_like(x, eps), x))


def compute_logmel(samples: torch.Tensor,
                   config: SpectrogramConfig) -> torch.Tensor:
  """Log-mel spectrogram of [..., n] samples -> [..., n//hop, mel_bins].

  The fused kernel on a CUDA tensor, the plain matmuls on a CPU tensor.
  """
  from mt3_tpu_torch.ops import logmel
  return logmel.logmel_fused(samples, config)


# ---------------------------------------------------------------------------
# Frame-level helpers mirroring spectrograms.py:55-82.
# ---------------------------------------------------------------------------
def split_audio(samples: np.ndarray,
                config: SpectrogramConfig) -> np.ndarray:
  """Split 1-D audio into non-overlapping hop-width frames (host-side)."""
  samples = np.asarray(samples, dtype=np.float32)
  remainder = len(samples) % config.hop_width
  if remainder:
    samples = np.pad(samples, (0, config.hop_width - remainder))
  return samples.reshape(-1, config.hop_width)


def flatten_frames(frames: torch.Tensor) -> torch.Tensor:
  """Convert [..., n_frames, hop] frames back to flat samples."""
  return frames.reshape(frames.shape[:-2] + (-1,))


def frames_to_logmel(frames: torch.Tensor,
                     config: SpectrogramConfig) -> torch.Tensor:
  """[..., n_frames, hop] audio frames -> [..., n_frames, mel] log-mel.

  The train step's features (mt3_tpu/ops/spectrogram.py:143-147): the
  fused kernel on a CUDA tensor, the plain matmuls on a CPU tensor.
  """
  return compute_logmel(flatten_frames(frames), config)
