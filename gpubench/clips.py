"""Piano-like audio from a seed (after chip_smoke.chord_clip, lines
343-355 of chip_smoke.py as this benchmark was written: a chord of three
pitches from MIDI 48-83 every half second, plus a little noise), with
each tone a decaying harmonic series instead of a sine.
"""

from __future__ import annotations

import numpy as np

CHORD_EVERY_S = 0.5
TONE_S = 1.0
HARMONICS = 4
DECAY_PER_S = 3.0


def piano_clip(seconds: float, rng: np.random.Generator,
               sample_rate: int = 16000) -> np.ndarray:
  """float32 audio of `seconds` seconds."""
  n = int(seconds * sample_rate)
  audio = np.zeros(n)
  tone = np.arange(int(TONE_S * sample_rate)) / sample_rate
  envelope = 0.2 * np.exp(-DECAY_PER_S * tone)
  for start in np.arange(0.0, seconds, CHORD_EVERY_S):
    first = int(start * sample_rate)
    span = min(len(tone), n - first)
    for pitch in rng.choice(np.arange(48, 84), size=3, replace=False):
      f0 = 440.0 * 2 ** ((pitch - 69) / 12)
      wave = sum(np.sin(2 * np.pi * k * f0 * tone[:span]) / k
                 for k in range(1, HARMONICS + 1))
      audio[first:first + span] += envelope[:span] * wave
  return (audio + 0.01 * rng.standard_normal(n)).astype(np.float32)
