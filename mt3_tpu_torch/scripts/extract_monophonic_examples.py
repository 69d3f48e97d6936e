"""Extract monophonic transcription examples from raw audio (copy of mt3_tpu/scripts/extract_monophonic_examples.py).

Rebuild of mt3/scripts/extract_monophonic_examples.py:
an f0 tracker feeds an HMM over {128 pitches + rest} whose Viterbi path
becomes a NoteSequence; clips judged monophonic (by f0-confidence
heuristic) are written as (audio, NoteSequence) training examples in
TFRecord form.

The reference's f0 tracker is CREPE (a neural model, unavailable here);
this implementation substitutes a normalized-autocorrelation tracker with
a periodicity-based confidence.  The HMM *parameters* (state space of 128
pitches + rest, Gaussian pitch emission with octave-error mixture,
confidence-as-P(voiced) exponent, uniform note-change transitions) are
the reference's published constants; the forward/Viterbi/segmentation
algorithms are original vectorized implementations (log-space forward,
[frames, states] lattice DP, run-length note segmentation).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional, Tuple

import numpy as np

F0_SAMPLE_RATE = 16000
F0_FRAME_RATE = 100

MONOPHONIC_CONFIDENCE_THRESHOLD = 0.95
MONOPHONIC_CONFIDENCE_FRAC = 0.2
CLIP_LENGTH_SECONDS = 5

# HMM parameters (reference values).
F0_MIDI_SIGMA = 0.2
OCTAVE_ERROR_PROB = 0.05
NOTES_PER_SECOND = 2
NOTE_CHANGE_PROB = NOTES_PER_SECOND / F0_FRAME_RATE
F0_CONFIDENCE_EXP = 7.5

NUM_PITCHES = 128
NUM_STATES = NUM_PITCHES + 1  # + rest


def hz_to_midi(hz: np.ndarray) -> np.ndarray:
  hz = np.maximum(np.asarray(hz, np.float64), 1e-6)
  return 69.0 + 12.0 * np.log2(hz / 440.0)


# ---------------------------------------------------------------------------
# f0 tracking (CREPE substitute)
# ---------------------------------------------------------------------------
def track_f0(audio: np.ndarray, sample_rate: int = F0_SAMPLE_RATE,
             fmin: float = 50.0, fmax: float = 2000.0
             ) -> Tuple[np.ndarray, np.ndarray]:
  """Frame-wise f0 (Hz) and confidence in [0, 1].

  Normalized autocorrelation over 64 ms windows at 100 fps; confidence is
  the autocorrelation peak value scaled by frame energy salience.
  """
  hop = sample_rate // F0_FRAME_RATE
  win = 1024
  lag_min = int(sample_rate / fmax)
  lag_max = min(int(sample_rate / fmin), win - 1)
  n_frames = max(0, (len(audio) - win) // hop + 1)
  f0 = np.zeros(n_frames)
  confidence = np.zeros(n_frames)
  window = np.hanning(win)
  for i in range(n_frames):
    frame = audio[i * hop:i * hop + win] * window
    energy = np.sqrt(np.mean(frame ** 2))
    if energy < 1e-4:
      continue
    spec = np.fft.rfft(frame, 2 * win)
    ac = np.fft.irfft(np.abs(spec) ** 2)[:win]
    if ac[0] <= 0:
      continue
    ac = ac / ac[0]
    seg = ac[lag_min:lag_max]
    if len(seg) == 0:
      continue
    peak = int(np.argmax(seg)) + lag_min
    # Parabolic interpolation around the peak.
    if 1 <= peak < win - 1:
      alpha, beta, gamma = ac[peak - 1], ac[peak], ac[peak + 1]
      denom = alpha - 2 * beta + gamma
      shift = 0.5 * (alpha - gamma) / denom if abs(denom) > 1e-12 else 0.0
      lag = peak + np.clip(shift, -1, 1)
    else:
      lag = peak
    f0[i] = sample_rate / lag
    confidence[i] = float(np.clip(ac[peak], 0.0, 1.0))
  return f0, confidence


def is_monophonic_heuristic(f0_confidence: np.ndarray) -> bool:
  """Reference heuristic: enough frames with very confident f0."""
  if len(f0_confidence) == 0:
    return False
  return (np.sum(f0_confidence >= MONOPHONIC_CONFIDENCE_THRESHOLD)
          / len(f0_confidence) >= MONOPHONIC_CONFIDENCE_FRAC)


# ---------------------------------------------------------------------------
# Pitch-tracking HMM.
#
# Parameter table per mt3/scripts/
# extract_monophonic_examples.py:44-57 (state space 128 pitches + rest;
# Gaussian pitch emission sigma 0.2 semitones with 5% octave-error mass;
# confidence^7.5 as P(voiced); 2 note changes/s).  Algorithms below are
# original vectorized implementations.
# ---------------------------------------------------------------------------
def _pitch_emission_density(f0_midi: np.ndarray) -> np.ndarray:
  """Pitch-emission term, vectorized over [frames, 128].

  Emission is a 3-component Gaussian mixture in MIDI space: the true
  pitch plus +/-1 octave errors.  Returns the raw mixture *density*,
  which the observation matrix adds directly to log-domain terms —
  deliberately reproducing the reference's arithmetic
  (extract_monophonic_examples.py:81-93 uses the density as if it were
  a log-likelihood; its own variable is named ``f0_midi_loglik``).
  Behavior parity with the reference's extracted datasets requires
  keeping that quirk; see PARITY.md "monophonic HMM emission".
  """
  # [frames, pitches, 3 octave hypotheses]
  offsets = np.array([0.0, 12.0, -12.0])
  weights = np.array([1.0 - OCTAVE_ERROR_PROB,
                      OCTAVE_ERROR_PROB / 2, OCTAVE_ERROR_PROB / 2])
  diff = (f0_midi[:, None, None]
          - np.arange(NUM_PITCHES)[None, :, None] + offsets)
  gauss = np.exp(-0.5 * (diff / F0_MIDI_SIGMA) ** 2)
  gauss /= F0_MIDI_SIGMA * np.sqrt(2 * np.pi)
  return gauss @ weights


def f0_hmm_matrices(f0_hz: np.ndarray, f0_confidence: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
  """Observation [frames, 129] and transition [129, 129] log-liks."""
  voiced_prob = np.power(np.clip(f0_confidence, 1e-9, 1 - 1e-9),
                         F0_CONFIDENCE_EXP)
  pitch_density = _pitch_emission_density(hz_to_midi(f0_hz))

  obs = np.empty((len(f0_hz), NUM_STATES))
  # Voiced states: the raw mixture density is added to the log-domain
  # confidence term, matching the reference arithmetic exactly (see
  # _pitch_emission_density docstring) so Viterbi paths and extracted
  # notes agree with the reference tool.
  obs[:, :NUM_PITCHES] = (pitch_density
                          + np.log(voiced_prob)[:, None]
                          - np.log(NUM_PITCHES))
  # Rest state: uniform over pitch observations.
  obs[:, NUM_PITCHES] = np.log1p(-voiced_prob) - np.log(NUM_PITCHES)
  # Reference normalizes by log(num_states); path-invariant.
  obs += np.log(NUM_STATES)

  # Stay with prob 1 - NOTE_CHANGE_PROB; otherwise jump uniformly.
  jump = NOTE_CHANGE_PROB / NUM_PITCHES
  trans = np.full((NUM_STATES, NUM_STATES), jump)
  np.fill_diagonal(trans, 1.0 - NOTE_CHANGE_PROB)
  return obs, np.log(trans)


def hmm_forward(obs_loglik: np.ndarray,
                trans_loglik: np.ndarray) -> float:
  """Total log P(observations): log-space forward pass.

  Works entirely in log domain (logsumexp over the transition lattice)
  rather than the classic rescaled linear-space recursion.
  """
  from scipy.special import logsumexp
  num_states = obs_loglik.shape[1]
  alpha = obs_loglik[0] - np.log(num_states)  # uniform initial state
  for obs_t in obs_loglik[1:]:
    alpha = logsumexp(alpha[:, None] + trans_loglik, axis=0) + obs_t
  return float(logsumexp(alpha))


def hmm_viterbi(obs_loglik: np.ndarray,
                trans_loglik: np.ndarray) -> List[Optional[int]]:
  """Most likely state path; None marks rest frames.

  Vectorized DP over the [frames, states] lattice with a dense
  backpointer table and a reverse reconstruction pass.
  """
  num_frames, num_states = obs_loglik.shape
  backptr = np.empty((num_frames, num_states), dtype=np.int64)
  score = obs_loglik[0] - np.log(num_states)
  for t in range(1, num_frames):
    cand = score[:, None] + trans_loglik  # [from, to]
    backptr[t] = np.argmax(cand, axis=0)
    score = np.take_along_axis(cand, backptr[t][None, :], axis=0)[0]
    score = score + obs_loglik[t]

  states = np.empty(num_frames, dtype=np.int64)
  states[-1] = int(np.argmax(score))
  for t in range(num_frames - 2, -1, -1):
    states[t] = backptr[t + 1, states[t + 1]]
  return [int(s) if s < NUM_PITCHES else None for s in states]


def pitches_to_notesequence(pitches: List[Optional[int]]):
  """Pitch path -> NoteSequence via vectorized run-length segmentation."""
  from mt3_tpu_torch.core.note_sequence import NoteSequence
  ns = NoteSequence(ticks_per_quarter=220)
  if not pitches:
    return ns
  # Encode rest as -1 so the whole path is one integer array, then find
  # run boundaries where the value changes.
  path = np.array([-1 if p is None else p for p in pitches])
  starts = np.flatnonzero(np.diff(path, prepend=path[0] - 1))
  ends = np.append(starts[1:], len(path))
  for start, end in zip(starts, ends):
    if path[start] < 0:
      continue
    ns.add_note(pitch=int(path[start]), velocity=100,
                start_time=start / F0_FRAME_RATE,
                end_time=end / F0_FRAME_RATE)
  if ns.notes:
    ns.total_time = max(n.end_time for n in ns.notes)
  return ns


@dataclasses.dataclass
class MonophonicClip:
  audio: np.ndarray
  sequence: 'NoteSequence'
  start_seconds: float


def extract_clips(audio: np.ndarray,
                  sample_rate: int = F0_SAMPLE_RATE
                  ) -> List[MonophonicClip]:
  """Split audio into 5 s clips; keep monophonic ones with transcripts."""
  clip_samples = CLIP_LENGTH_SECONDS * sample_rate
  clips = []
  for start in range(0, len(audio) - clip_samples + 1, clip_samples):
    clip = audio[start:start + clip_samples]
    f0, confidence = track_f0(clip, sample_rate)
    if not is_monophonic_heuristic(confidence):
      continue
    obs, trans = f0_hmm_matrices(f0, confidence)
    pitches = hmm_viterbi(obs, trans)
    ns = pitches_to_notesequence(pitches)
    if not ns.notes:
      continue
    clips.append(MonophonicClip(audio=clip, sequence=ns,
                                start_seconds=start / sample_rate))
  return clips


def main(argv=None):
  parser = argparse.ArgumentParser(
      description='Extract monophonic examples to TFRecord')
  parser.add_argument('inputs', nargs='+', help='input .wav files')
  parser.add_argument('--output', required=True, help='output TFRecord')
  args = parser.parse_args(argv)

  from mt3_tpu_torch.core import midi_io
  from mt3_tpu_torch.data import tfrecord
  from mt3_tpu_torch.data.datasets import read_wav

  records = []
  for path in args.inputs:
    audio = read_wav(path, F0_SAMPLE_RATE)
    clips = extract_clips(audio)
    print(f'{path}: {len(clips)} monophonic clips', file=sys.stderr)
    for clip in clips:
      records.append(tfrecord.make_example({
          'audio': clip.audio.astype(np.float32),
          'sequence': [midi_io.note_sequence_to_midi(clip.sequence)],
          'id': [f'{path}:{clip.start_seconds}'.encode()],
      }))
  tfrecord.write_records(args.output, records)
  print(f'wrote {len(records)} examples to {args.output}',
        file=sys.stderr)


if __name__ == '__main__':
  main()
