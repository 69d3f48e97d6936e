"""Procedural polyphonic multi-program corpus (a synthetic "Slakh") (copy of mt3_tpu/data/synth.py).

The reference trains its flagship multitask model on mixes of real
corpora — Slakh2100 multi-track renders above all
(mt3/datasets.py:275-323, tasks.py:345-359).  This
environment has no data egress, so this module provides the closest
*learnable* stand-in: procedurally composed multi-instrument note
sequences rendered with a deterministic per-program additive
synthesizer.  Every General-MIDI program gets a stable, distinctive
timbre (harmonic recipe, envelope, vibrato), and drums get per-pitch
percussive textures, so that audio -> (onset, offset, program, drum)
transcription is an actually solvable inverse problem — unlike the
pure-sine `SyntheticDataSource`, where all programs sound identical and
the program token is unlearnable.

Used by tools/make_corpus.py to materialize the training segment cache
and held-out eval splits for the flagship training runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mt3_tpu_torch.data.datasets import DataSource
from mt3_tpu_torch.core.note_sequence import NoteSequence


# ---------------------------------------------------------------------------
# Per-program timbres
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Timbre:
  """Additive-synthesis recipe for one instrument program."""
  harmonic_amps: Tuple[float, ...]  # relative amplitude per harmonic
  attack_s: float                   # linear attack time
  decay_rate: float                 # exponential decay toward sustain, 1/s
  sustain_level: float              # 0..1 fraction of peak after decay
  release_s: float                  # linear release after note-off
  vibrato_hz: float                 # frequency-modulation rate (0 = none)
  vibrato_depth: float              # FM depth in fractional pitch
  noise_amp: float                  # breath/bow noise mixed in


def timbre_for_program(program: int) -> Timbre:
  """Deterministic, distinctive timbre for a GM program number.

  Parameters are drawn from a program-seeded RNG, so any two programs
  differ in harmonic recipe and envelope while remaining stable across
  runs — the invariant a transcription model needs to learn program
  identity from audio.
  """
  rng = np.random.RandomState(0x5EED + 7919 * int(program))
  n_harmonics = int(rng.randint(4, 13))
  rolloff = rng.uniform(0.7, 2.2)
  amps = np.arange(1, n_harmonics + 1, dtype=np.float64) ** (-rolloff)
  # Parity tilt: clarinet-like programs suppress even harmonics,
  # brass-like ones boost them.
  parity = rng.uniform(-0.8, 0.8)
  amps[1::2] *= 1.0 + parity
  # One resonance bump at a random harmonic.
  bump = int(rng.randint(1, n_harmonics + 1))
  amps[bump - 1] *= rng.uniform(1.0, 2.5)
  amps /= amps.max()
  percussive = rng.rand() < 0.4  # piano/pluck family vs sustained family
  if percussive:
    attack, decay, sustain = rng.uniform(0.002, 0.01), rng.uniform(2.0, 6.0), rng.uniform(0.0, 0.25)
    vib_hz, vib_depth = 0.0, 0.0
  else:
    attack, decay, sustain = rng.uniform(0.02, 0.1), rng.uniform(0.3, 1.5), rng.uniform(0.5, 0.9)
    vib_hz, vib_depth = rng.uniform(4.0, 6.5), rng.uniform(0.0, 0.008)
  return Timbre(
      harmonic_amps=tuple(float(a) for a in amps),
      attack_s=float(attack),
      decay_rate=float(decay),
      sustain_level=float(sustain),
      release_s=float(rng.uniform(0.01, 0.08)),
      vibrato_hz=float(vib_hz),
      vibrato_depth=float(vib_depth),
      noise_amp=float(rng.uniform(0.0, 0.02)))


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------
def _render_pitched_note(audio: np.ndarray, sample_rate: int, pitch: int,
                         velocity: int, start: float, end: float,
                         timbre: Timbre, rng: np.random.RandomState) -> None:
  freq = 440.0 * 2.0 ** ((pitch - 69) / 12.0)
  i0 = int(round(start * sample_rate))
  i1 = min(int(round((end + timbre.release_s) * sample_rate)), len(audio))
  n = i1 - i0
  if n <= 0:
    return
  t = np.arange(n, dtype=np.float64) / sample_rate

  # Envelope: linear attack -> exponential decay toward sustain -> release.
  env = np.minimum(1.0, t / max(timbre.attack_s, 1e-4))
  env *= (timbre.sustain_level + (1.0 - timbre.sustain_level)
          * np.exp(-t * timbre.decay_rate))
  dur = end - start
  rel = np.clip((t - dur) / max(timbre.release_s, 1e-3), 0.0, 1.0)
  env *= 1.0 - rel

  phase0 = rng.uniform(0.0, 2 * np.pi)
  if timbre.vibrato_hz > 0.0:
    vib = timbre.vibrato_depth * np.sin(2 * np.pi * timbre.vibrato_hz * t)
    inst_phase = 2 * np.pi * freq * (t + vib / timbre.vibrato_hz)
  else:
    inst_phase = 2 * np.pi * freq * t

  nyquist = sample_rate / 2.0
  wave = np.zeros(n, dtype=np.float64)
  for k, amp in enumerate(timbre.harmonic_amps, start=1):
    if freq * k >= nyquist:
      break
    wave += amp * np.sin(k * inst_phase + phase0 * k)
  if timbre.noise_amp > 0.0:
    wave += timbre.noise_amp * rng.randn(n)
  audio[i0:i1] += (velocity / 127.0) * env * wave


# Per-pitch drum textures: (tonal freq or None, noise lowpass 0..1, decay 1/s)
_DRUM_RECIPES: Dict[int, Tuple[Optional[float], float, float]] = {
    35: (55.0, 0.9, 28.0),   # acoustic bass drum
    36: (60.0, 0.9, 25.0),   # kick
    38: (180.0, 0.4, 18.0),  # snare
    40: (200.0, 0.35, 16.0), # electric snare
    42: (None, 0.05, 60.0),  # closed hi-hat
    46: (None, 0.05, 10.0),  # open hi-hat
    45: (110.0, 0.7, 12.0),  # low tom
    48: (160.0, 0.7, 12.0),  # hi-mid tom
    49: (None, 0.02, 3.5),   # crash
    51: (None, 0.03, 6.0),   # ride
}


def _render_drum_note(audio: np.ndarray, sample_rate: int, pitch: int,
                      velocity: int, start: float,
                      rng: np.random.RandomState) -> None:
  tone_freq, lowpass, decay = _DRUM_RECIPES.get(
      pitch, (None, 0.3, 20.0))
  dur_s = min(4.6 / decay, 1.5)
  i0 = int(round(start * sample_rate))
  i1 = min(i0 + int(dur_s * sample_rate), len(audio))
  n = i1 - i0
  if n <= 0:
    return
  t = np.arange(n, dtype=np.float64) / sample_rate
  env = np.exp(-t * decay)
  noise = rng.randn(n)
  if lowpass > 0.0:  # one-pole lowpass colors the noise per drum
    # y[i] = (1-a) sum_k a^k x[i-k]; truncated impulse response.
    taps = lowpass ** np.arange(min(n, 256), dtype=np.float64)
    noise = (1.0 - lowpass) * np.convolve(noise, taps)[:n]
  wave = noise
  if tone_freq is not None:
    # pitch-sweeping thump
    sweep = tone_freq * (1.0 + 1.5 * np.exp(-t * 40.0))
    wave = 0.5 * noise + np.sin(2 * np.pi * np.cumsum(sweep) / sample_rate)
  audio[i0:i1] += 0.6 * (velocity / 127.0) * env * wave


def render_note_sequence(ns: NoteSequence, duration: float,
                         sample_rate: int = 16000,
                         seed: int = 0) -> np.ndarray:
  """Render a NoteSequence to mono float32 audio in [-1, 1]."""
  n = int(round(duration * sample_rate))
  audio = np.zeros(n, dtype=np.float64)
  rng = np.random.RandomState(seed)
  timbres: Dict[int, Timbre] = {}
  for note in ns.notes:
    if note.is_drum:
      _render_drum_note(audio, sample_rate, note.pitch, note.velocity,
                        note.start_time, rng)
    else:
      if note.program not in timbres:
        timbres[note.program] = timbre_for_program(note.program)
      _render_pitched_note(audio, sample_rate, note.pitch, note.velocity,
                           note.start_time, note.end_time,
                           timbres[note.program], rng)
  peak = np.max(np.abs(audio))
  if peak > 0:
    audio /= peak * 1.05
  return audio.astype(np.float32)


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------
# Default program pool: one representative per broad GM family, so 'full'
# program granularity has a diverse but learnable label set.
DEFAULT_PROGRAMS: Tuple[int, ...] = (
    0, 4, 16, 24, 26, 32, 40, 42, 56, 61, 64, 71, 73, 80)

_SCALES = [
    (0, 2, 4, 5, 7, 9, 11),   # major
    (0, 2, 3, 5, 7, 8, 10),   # natural minor
    (0, 2, 4, 7, 9),          # pentatonic
]


def _compose_track(rng: np.random.RandomState, program: int, style: str,
                   duration: float, root: int,
                   scale: Sequence[int]) -> List[dict]:
  """One instrument's notes: list of add_note kwargs."""
  notes: List[dict] = []
  if style == 'bass':
    lo, hi, max_poly = 28, 52, 1
    dur_range, gap_range = (0.2, 0.7), (0.0, 0.4)
  elif style == 'chords':
    lo, hi, max_poly = 48, 76, 4
    dur_range, gap_range = (0.6, 2.2), (0.0, 0.5)
  else:  # melody / arpeggio
    lo, hi, max_poly = 55, 88, 1
    dur_range, gap_range = (0.12, 0.6), (0.0, 0.25)

  degrees = [root + 12 * octave + d
             for octave in range(-2, 4) for d in scale]
  degrees = [p for p in degrees if lo <= p <= hi]
  if not degrees:
    degrees = list(range(lo, hi))
  idx = int(rng.randint(len(degrees)))
  time = float(rng.uniform(0.05, 0.5))
  active_until: Dict[int, float] = {}
  while time < duration - 0.15:
    n_poly = 1 if max_poly == 1 else int(rng.randint(1, max_poly + 1))
    dur = float(rng.uniform(*dur_range))
    chord_offsets = rng.choice([0, 2, 4, 5, 7], size=n_poly, replace=False)
    for off in chord_offsets:
      j = min(idx + int(off) // 2, len(degrees) - 1)
      pitch = degrees[j]
      if active_until.get(pitch, 0.0) > time:  # no same-pitch overlap
        continue
      end = min(time + dur, duration - 0.01)
      if end - time < 0.02:
        continue
      notes.append(dict(pitch=int(pitch),
                        velocity=int(rng.randint(48, 127)),
                        start_time=round(time, 3), end_time=round(end, 3),
                        program=int(program)))
      active_until[pitch] = end
    idx = int(np.clip(idx + rng.randint(-3, 4), 0, len(degrees) - 1))
    time += dur * float(rng.uniform(0.4, 1.1)) + float(rng.uniform(*gap_range))
  return notes


def _compose_drums(rng: np.random.RandomState, duration: float) -> List[dict]:
  notes: List[dict] = []
  beat = float(rng.uniform(0.3, 0.6))
  time = float(rng.uniform(0.0, beat))
  i = 0
  while time < duration - 0.1:
    hits = []
    if i % 2 == 0 and rng.rand() < 0.9:
      hits.append(36)
    if i % 2 == 1 and rng.rand() < 0.7:
      hits.append(38)
    if rng.rand() < 0.6:
      hits.append(42)
    for pitch in hits:
      notes.append(dict(pitch=pitch, velocity=int(rng.randint(64, 127)),
                        start_time=round(time, 3),
                        end_time=round(time + 0.01, 3), is_drum=True))
    time += beat * float(rng.uniform(0.95, 1.05))
    i += 1
  return notes


def compose_example(seed: int, duration: float,
                    programs: Sequence[int] = DEFAULT_PROGRAMS,
                    max_instruments: int = 3,
                    drum_prob: float = 0.5) -> NoteSequence:
  """Compose one multi-instrument NoteSequence, deterministic in seed."""
  rng = np.random.RandomState(seed)
  ns = NoteSequence()
  ns.id = f'polysynth-{seed}'
  root = int(rng.randint(0, 12)) + 48
  scale = _SCALES[int(rng.randint(len(_SCALES)))]
  n_instruments = int(rng.randint(1, max_instruments + 1))
  chosen = rng.choice(len(programs), size=n_instruments, replace=False)
  styles = ['melody', 'chords', 'bass']
  rng.shuffle(styles)
  all_notes: List[dict] = []
  for slot, prog_idx in enumerate(chosen):
    style = styles[slot % len(styles)]
    all_notes.extend(_compose_track(
        rng, programs[int(prog_idx)], style, duration, root, scale))
  if rng.rand() < drum_prob:
    all_notes.extend(_compose_drums(rng, duration))
  for kwargs in sorted(all_notes,
                       key=lambda kw: (kw['start_time'], kw['pitch'])):
    ns.add_note(**kwargs)
  ns.total_time = duration
  return ns


class PolyphonicSynthDataSource(DataSource):
  """Polyphonic multi-program procedural corpus.

  Deterministic per (seed, index): disjoint seed ranges give disjoint
  train/eval splits.  Examples yield {'sequence', 'audio'} like every
  other DataSource.
  """

  def __init__(self, num_examples: int = 64, duration: float = 8.192,
               sample_rate: int = 16000, seed: int = 0,
               programs: Sequence[int] = DEFAULT_PROGRAMS,
               max_instruments: int = 3, drum_prob: float = 0.5):
    self.num_examples = num_examples
    self.duration = duration
    self.sample_rate = sample_rate
    self.seed = seed
    self.programs = tuple(programs)
    self.max_instruments = max_instruments
    self.drum_prob = drum_prob

  def __len__(self) -> int:
    return self.num_examples

  def example(self, i: int) -> Dict:
    ns = compose_example(self.seed + i, self.duration, self.programs,
                         self.max_instruments, self.drum_prob)
    audio = render_note_sequence(ns, self.duration, self.sample_rate,
                                 seed=self.seed + i)
    return {'sequence': ns, 'audio': audio}

  def examples(self) -> Iterator[Dict]:
    for i in range(self.num_examples):
      yield self.example(i)
