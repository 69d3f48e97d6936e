"""WAV reading for the port (copy of read_wav / resample_audio from
mt3_tpu/data/datasets.py).  The dataset registry is not ported yet."""

from __future__ import annotations

import wave

import numpy as np


def resample_audio(samples: np.ndarray, rate: int,
                   expected_rate: int) -> np.ndarray:
  """Polyphase resample (host side; replaces librosa.resample)."""
  if rate == expected_rate:
    return samples.astype(np.float32)
  from math import gcd
  from scipy.signal import resample_poly
  g = gcd(int(rate), int(expected_rate))
  return resample_poly(samples, expected_rate // g,
                       rate // g).astype(np.float32)


def read_wav(path, expected_rate: int) -> np.ndarray:
  """Minimal WAV reader (PCM16/PCM32/float32), mono-mixed, resampled.

  `path` may be a filename or a binary file object.
  """
  with wave.open(path, 'rb') as w:
    rate = w.getframerate()
    n = w.getnframes()
    width = w.getsampwidth()
    channels = w.getnchannels()
    raw = w.readframes(n)
  if width == 2:
    samples = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
  elif width == 4:
    samples = np.frombuffer(raw, np.int32).astype(np.float32) / 2**31
  else:
    raise ValueError(f'unsupported sample width: {width}')
  if channels > 1:
    samples = samples.reshape(-1, channels).mean(axis=1)
  return resample_audio(samples, rate, expected_rate)
