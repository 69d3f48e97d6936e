"""Log-mel features from raw audio, in plain NumPy and PyTorch.

The mel filterbank is tf.signal.linear_to_mel_weight_matrix's (HTK mel
scale, triangular bands over linearly spaced bin centres, the DC bin
zeroed), computed in float32 as TensorFlow does; the spectrum is the real
FFT of Hann-windowed frames in float64.  Framing is tf.signal.stft with
pad_end=True for a sample count that is a multiple of the hop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

EPS = 1e-5


def _hertz_to_mel(f, dtype):
  return (dtype(1127.0) * np.log(dtype(1.0) + np.asarray(f, dtype)
                                 / dtype(700.0))).astype(dtype)


@functools.lru_cache(maxsize=None)
def mel_matrix(num_mel_bins, num_spectrogram_bins, sample_rate, lo_hz,
               hi_hz) -> np.ndarray:
  """[num_spectrogram_bins, num_mel_bins] float32 weights."""
  dtype = np.float32
  freqs = np.linspace(dtype(0.0), dtype(sample_rate / 2.0),
                      num_spectrogram_bins, dtype=dtype)[1:]
  bins_mel = _hertz_to_mel(freqs, dtype)[:, None]
  edges = np.linspace(_hertz_to_mel(lo_hz, dtype), _hertz_to_mel(hi_hz, dtype),
                      num_mel_bins + 2, dtype=dtype)
  lower, center, upper = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
  weights = np.maximum(0.0, np.minimum((bins_mel - lower) / (center - lower),
                                       (upper - bins_mel) / (upper - center)))
  return np.pad(weights, [[1, 0], [0, 0]]).astype(dtype)


def spec_mel_matrix(spec) -> np.ndarray:
  return mel_matrix(spec['num_mel_bins'], spec['fft_size'] // 2 + 1,
                    spec['sample_rate'], spec['mel_lo_hz'], spec['mel_hi_hz'])


def logmel(samples: torch.Tensor, spec) -> torch.Tensor:
  """[b, n] float32 audio -> [b, n // hop, mel] float32 log-mel."""
  hop, fft = spec['hop_width'], spec['fft_size']
  x = samples.to(torch.float64)
  x = torch.nn.functional.pad(x, (0, fft - hop))
  frames = x.unfold(-1, fft, hop)
  n = torch.arange(fft, dtype=torch.float64, device=x.device)
  window = 0.5 - 0.5 * torch.cos(2.0 * np.pi * n / fft)
  magnitude = torch.fft.rfft(frames * window, n=fft).abs()
  mel = magnitude @ torch.from_numpy(spec_mel_matrix(spec)).to(
      x.device, torch.float64)
  return torch.log(torch.where(mel <= 0.0, torch.full_like(mel, EPS),
                               mel)).to(torch.float32)
