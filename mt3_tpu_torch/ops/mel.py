"""Mel filterbank matrix construction (host-side, NumPy).

Matches the semantics of tf.signal.linear_to_mel_weight_matrix, which the
reference uses at mt3/spectral_ops.py:69-71: HTK mel scale
(1127 * ln(1 + f/700)), num_mel_bins triangular bands between lower and
upper edge frequencies over linearly spaced spectrogram bin center
frequencies, with the first (DC) spectrogram bin zeroed.
"""

from __future__ import annotations

import functools

import numpy as np

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def hertz_to_mel(frequencies_hertz: np.ndarray,
                 dtype=np.float64) -> np.ndarray:
  frequencies_hertz = np.asarray(frequencies_hertz, dtype=dtype)
  return (dtype(_MEL_HIGH_FREQUENCY_Q)
          * np.log(dtype(1.0) + frequencies_hertz
                   / dtype(_MEL_BREAK_FREQUENCY_HERTZ))).astype(dtype)


@functools.lru_cache(maxsize=None)
def linear_to_mel_weight_matrix(
    num_mel_bins: int = 20,
    num_spectrogram_bins: int = 129,
    sample_rate: float = 8000.0,
    lower_edge_hertz: float = 125.0,
    upper_edge_hertz: float = 3800.0,
    dtype=np.float32,
) -> np.ndarray:
  """[num_spectrogram_bins, num_mel_bins] triangular mel weight matrix."""
  if num_mel_bins <= 0:
    raise ValueError('num_mel_bins must be positive')
  if lower_edge_hertz >= upper_edge_hertz:
    raise ValueError('lower_edge_hertz must be < upper_edge_hertz')
  nyquist_hertz = sample_rate / 2.0
  if upper_edge_hertz > nyquist_hertz:
    raise ValueError('upper_edge_hertz must not exceed Nyquist')

  # All arithmetic is carried out in `dtype` (float32 by default) to match
  # the TF implementation bit-for-bit.
  dtype = np.dtype(dtype).type

  # Spectrogram bin center frequencies; drop the DC bin from the band
  # computation (it is zeroed in the output).
  bands_to_zero = 1
  linear_frequencies = np.linspace(
      dtype(0.0), dtype(nyquist_hertz),
      num_spectrogram_bins, dtype=dtype)[bands_to_zero:]
  spectrogram_bins_mel = hertz_to_mel(linear_frequencies,
                                      dtype=dtype)[:, np.newaxis]

  # num_mel_bins + 2 band edges, equally spaced in mel scale; sliding
  # triples give (lower, center, upper) for each triangular band.
  band_edges_mel = np.linspace(
      hertz_to_mel(lower_edge_hertz, dtype=dtype),
      hertz_to_mel(upper_edge_hertz, dtype=dtype),
      num_mel_bins + 2, dtype=dtype)
  lower_edge_mel = band_edges_mel[np.newaxis, :-2]
  center_mel = band_edges_mel[np.newaxis, 1:-1]
  upper_edge_mel = band_edges_mel[np.newaxis, 2:]

  lower_slopes = (spectrogram_bins_mel - lower_edge_mel) / (
      center_mel - lower_edge_mel)
  upper_slopes = (upper_edge_mel - spectrogram_bins_mel) / (
      upper_edge_mel - center_mel)
  mel_weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))

  # Re-add the zeroed DC row.
  return np.pad(mel_weights, [[bands_to_zero, 0], [0, 0]]).astype(dtype)
