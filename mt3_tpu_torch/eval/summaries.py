"""Evaluation summaries: synthesized audio and pianoroll images.

Rebuild of mt3/summaries.py without fluidsynth /
TensorBoard: predictions are rendered to audio with a lightweight additive
synthesizer, and pianoroll comparisons (est vs ref, with segment-boundary
lines) are rendered to RGB arrays / PNG files.  Writers emit plain files
under a summary directory; anything that reads TensorBoard event files in
the reference is replaced by this directory layout.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

import numpy as np

from mt3_tpu_torch.core.note_sequence import NoteSequence


def synthesize(ns: NoteSequence, sample_rate: int = 16000,
               wave_fn=np.sin) -> np.ndarray:
  """Very small additive synthesizer (fluidsynth stand-in).

  Notes render as enveloped sines at their MIDI frequency; drums as short
  noise bursts.
  """
  total = max([n.end_time for n in ns.notes], default=0.0) + 0.2
  out = np.zeros(int(total * sample_rate) + 1, np.float32)
  t = np.arange(len(out)) / sample_rate
  for note in ns.notes:
    amp = note.velocity / 127.0 * 0.2
    if note.is_drum:
      i0 = int(note.start_time * sample_rate)
      n = int(0.05 * sample_rate)
      rng = np.random.RandomState(note.pitch)
      out[i0:i0 + n] += amp * rng.randn(min(n, len(out) - i0)).astype(
          np.float32)
      continue
    freq = 440.0 * 2 ** ((note.pitch - 69) / 12.0)
    mask = (t >= note.start_time) & (t < note.end_time)
    seg = t[mask]
    env = np.exp(-(seg - note.start_time) * 3.0)
    out[mask] += (amp * env * wave_fn(2 * np.pi * freq * seg)).astype(
        np.float32)
  peak = np.max(np.abs(out))
  return out / peak if peak > 1.0 else out


def write_wav(path: str, samples: np.ndarray,
              sample_rate: int = 16000) -> None:
  import wave
  pcm = np.clip(samples * 32767, -32768, 32767).astype(np.int16)
  with wave.open(path, 'wb') as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(sample_rate)
    w.writeframes(pcm.tobytes())


def pianoroll_image(est_ns: NoteSequence, ref_ns: Optional[NoteSequence],
                    fps: float = 62.5,
                    segment_start_times: Sequence[float] = (),
                    max_seconds: float = 60.0) -> np.ndarray:
  """RGB comparison pianoroll [128, T, 3] uint8.

  Red = estimated only, green = reference only, yellow = both; thin blue
  columns mark segment boundaries (the reference draws the same lines,
  summaries.py:231-321).
  """
  def roll_of(ns):
    roll = np.zeros((128, int(max_seconds * fps)), bool)
    if ns is None:
      return roll
    for note in ns.notes:
      i0 = int(note.start_time * fps)
      i1 = max(int(note.end_time * fps), i0 + 1)
      roll[note.pitch, i0:min(i1, roll.shape[1])] = True
    return roll

  est = roll_of(est_ns)
  ref = roll_of(ref_ns)
  t_max = int(max(est.any(axis=0).nonzero()[0].max(initial=0),
                  ref.any(axis=0).nonzero()[0].max(initial=0))) + 10
  est, ref = est[:, :t_max], ref[:, :t_max]

  img = np.zeros((128, t_max, 3), np.uint8)
  img[..., 0] = np.where(est, 255, 0)   # red channel: estimate
  img[..., 1] = np.where(ref, 255, 0)   # green channel: reference
  for start in segment_start_times:
    col = int(start * fps)
    if 0 <= col < t_max:
      img[:, col, 2] = 128
  return img[::-1]  # high pitches on top


def save_png(path: str, image: np.ndarray) -> None:
  from PIL import Image
  Image.fromarray(image).save(path)


def write_transcription_summaries(
    results: Mapping[int, Mapping],
    targets: Mapping[int, Mapping],
    output_dir: str,
    sample_rate: int = 16000,
    num_examples: int = 5,
) -> None:
  """Write per-example est/ref audio + comparison pianorolls.

  `results` maps unique_id -> combined prediction dict (est_ns,
  start_times); `targets` maps unique_id -> {'ref_ns': NoteSequence}.
  """
  os.makedirs(output_dir, exist_ok=True)
  for i, uid in enumerate(sorted(results.keys())[:num_examples]):
    result = results[uid]
    ref_ns = targets.get(uid, {}).get('ref_ns')
    est_ns = result['est_ns']
    write_wav(os.path.join(output_dir, f'{uid}_est.wav'),
              synthesize(est_ns, sample_rate), sample_rate)
    if ref_ns is not None:
      write_wav(os.path.join(output_dir, f'{uid}_ref.wav'),
                synthesize(ref_ns, sample_rate), sample_rate)
    img = pianoroll_image(est_ns, ref_ns,
                          segment_start_times=result.get('start_times',
                                                         ()))
    save_png(os.path.join(output_dir, f'{uid}_pianoroll.png'), img)
    del i
