"""Data sources and WAV reading for the port (copies from
mt3_tpu/data/datasets.py).

Copied: DataSource, SyntheticDataSource (procedural note sequences with
additive-sine audio, the training smoke corpus), read_wav and
resample_audio.  resolve_data_source takes 'synthetic'; the corpus
registry, local wav+midi directories, the polyphonic synth and TFRecord
sources are not ported yet and raise.
"""

from __future__ import annotations

import wave
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from mt3_tpu_torch.core.config import SpectrogramConfig
from mt3_tpu_torch.core.note_sequence import NoteSequence

DATA_NOT_PORTED = (
    'only --data synthetic is ported; {spec!r} needs the corpus registry '
    'and TFRecord/segment-cache readers (ROADMAP.md, modules to port: '
    'training data sources)')


class DataSource:
  """Iterable of {'sequence': NoteSequence, 'audio': float32 samples}."""

  def __len__(self) -> int:
    raise NotImplementedError

  def examples(self) -> Iterator[Dict]:
    raise NotImplementedError


class SyntheticDataSource(DataSource):
  """Procedural music: random note sequences + additive-sine rendering."""

  def __init__(self, num_examples: int = 8, duration: float = 4.0,
               sample_rate: int = 16000, seed: int = 0,
               polyphony: int = 3, include_drums: bool = False,
               programs: Sequence[int] = (0,)):
    self.num_examples = num_examples
    self.duration = duration
    self.sample_rate = sample_rate
    self.seed = seed
    self.polyphony = polyphony
    self.include_drums = include_drums
    self.programs = programs

  def __len__(self):
    return self.num_examples

  def _render(self, ns: NoteSequence) -> np.ndarray:
    n = int(self.duration * self.sample_rate)
    audio = np.zeros(n, np.float32)
    t = np.arange(n) / self.sample_rate
    for note in ns.notes:
      if note.is_drum:
        i0, i1 = int(note.start_time * self.sample_rate), int(
            (note.start_time + 0.05) * self.sample_rate)
        rng = np.random.RandomState(note.pitch)
        burst = rng.randn(max(i1 - i0, 1)).astype(np.float32)
        audio[i0:i0 + len(burst)] += 0.3 * burst * (
            note.velocity / 127.0)
        continue
      freq = 440.0 * 2 ** ((note.pitch - 69) / 12.0)
      mask = (t >= note.start_time) & (t < note.end_time)
      seg = t[mask]
      env = np.minimum(1.0, (seg - note.start_time) * 100)
      env *= np.exp(-(seg - note.start_time) * 2.0)
      audio[mask] += (note.velocity / 127.0) * env * np.sin(
          2 * np.pi * freq * seg).astype(np.float32)
    peak = np.max(np.abs(audio))
    return audio / peak if peak > 0 else audio

  def examples(self):
    for i in range(self.num_examples):
      rng = np.random.RandomState(self.seed + i)
      ns = NoteSequence()
      ns.id = f'synthetic-{i}'
      time = 0.1
      while time < self.duration - 0.3:
        for _ in range(rng.randint(1, self.polyphony + 1)):
          pitch = int(rng.randint(48, 84))
          dur = float(rng.uniform(0.1, 0.8))
          program = int(self.programs[rng.randint(len(self.programs))])
          ns.add_note(pitch=pitch, velocity=int(rng.randint(32, 127)),
                      start_time=round(time, 3),
                      end_time=round(min(time + dur, self.duration), 3),
                      program=program)
        if self.include_drums and rng.rand() < 0.5:
          ns.add_note(pitch=int(rng.choice([36, 38, 42])),
                      velocity=int(rng.randint(64, 127)),
                      start_time=round(time, 3),
                      end_time=round(time + 0.01, 3), is_drum=True)
        time += float(rng.uniform(0.2, 0.6))
      ns.total_time = self.duration
      yield {'sequence': ns, 'audio': self._render(ns)}


def resolve_data_source(spec: str,
                        spectrogram_config=SpectrogramConfig(),
                        num_examples: Optional[int] = None,
                        seed: int = 0) -> DataSource:
  """Map a CLI --data spec to a DataSource: 'synthetic' only, as yet."""
  if spec == 'synthetic':
    return SyntheticDataSource(num_examples=num_examples or 4,
                               duration=4.0,
                               sample_rate=spectrogram_config.sample_rate,
                               seed=seed)
  raise NotImplementedError(DATA_NOT_PORTED.format(spec=spec))


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
