"""Transcription metric families.

Rebuild of mt3/metrics.py:36-392 without mir_eval /
sklearn / pretty_midi: note P/R/F1 (onset; onset+offset; +velocity),
program-aware scores at all granularities with drum onset-only handling,
onset-tolerance sweep, and framewise pianoroll metrics.
"""

from __future__ import annotations

import collections
import functools
from typing import Any, Iterable, Mapping, Optional, Sequence

import numpy as np

from mt3_tpu_torch.codec import event_codec, note_events, vocabulary
from mt3_tpu_torch.core.note_sequence import (NoteSequence,
                                        sequence_to_valued_intervals)
from mt3_tpu_torch.eval import transcription
from mt3_tpu_torch.infer import postprocess

DEFAULT_FRAME_FPS = 62.5
DEFAULT_FRAME_VELOCITY_THRESHOLD = 30


# ---------------------------------------------------------------------------
# Pianoroll / frame metrics (replaces pretty_midi.get_piano_roll + sklearn).
# ---------------------------------------------------------------------------
def get_pianoroll(ns: NoteSequence, fps: float,
                  is_drum: bool = False) -> np.ndarray:
  """[128, T] velocity pianoroll.

  Mirrors metrics_utils.get_prettymidi_pianoroll semantics
  (reference metrics_utils.py:149-171): every drum note, and every note
  shorter than 50 ms, is given a fixed 50 ms length; overlapping note
  velocities add.
  """
  notes = []
  end_time = 0.0
  for note in ns.notes:
    note_end = note.end_time
    if is_drum or note.end_time - note.start_time < 0.05:
      note_end = note.start_time + 0.05
    notes.append((note.pitch, note.velocity, note.start_time, note_end))
    end_time = max(end_time, note_end)

  n_frames = int(np.ceil(end_time * fps)) if notes else 0
  roll = np.zeros((128, max(n_frames, 1)), dtype=np.float64)
  for pitch, velocity, start, end in notes:
    i0 = int(start * fps)
    i1 = max(int(end * fps), i0 + 1)
    roll[pitch, i0:i1] += velocity
  return roll


def frame_metrics(ref_pianoroll: np.ndarray, est_pianoroll: np.ndarray,
                  velocity_threshold: int) -> tuple:
  """Frame precision / recall / F1 (reference metrics_utils.py:174-196)."""
  if ref_pianoroll.shape[1] > est_pianoroll.shape[1]:
    diff = ref_pianoroll.shape[1] - est_pianoroll.shape[1]
    est_pianoroll = np.pad(est_pianoroll, [(0, 0), (0, diff)])
  elif est_pianoroll.shape[1] > ref_pianoroll.shape[1]:
    diff = est_pianoroll.shape[1] - ref_pianoroll.shape[1]
    ref_pianoroll = np.pad(ref_pianoroll, [(0, 0), (0, diff)])

  # Quiet reference notes are dropped (consistent with Cerberus); all
  # estimated notes count.
  ref = (ref_pianoroll > velocity_threshold).flatten()
  est = (est_pianoroll > 0).flatten()

  tp = float(np.sum(ref & est))
  fp = float(np.sum(~ref & est))
  fn = float(np.sum(ref & ~est))
  precision = tp / (tp + fp) if tp + fp else 0.0
  recall = tp / (tp + fn) if tp + fn else 0.0
  return precision, recall, transcription.f_measure(precision, recall)


# ---------------------------------------------------------------------------
# Program-aware and tolerance-sweep scores.
# ---------------------------------------------------------------------------
def _program_aware_note_scores(
    ref_ns: NoteSequence, est_ns: NoteSequence,
    granularity_type: str) -> Mapping[str, float]:
  """Reference metrics.py:36-146: per-(program, is_drum) weighted P/R/F1."""
  program_map_fn = vocabulary.PROGRAM_GRANULARITIES[
      granularity_type].program_map_fn

  ref_ns = ref_ns.copy()
  for note in ref_ns.notes:
    if not note.is_drum:
      note.program = program_map_fn(note.program)
  est_ns = est_ns.copy()
  for note in est_ns.notes:
    if not note.is_drum:
      note.program = program_map_fn(note.program)

  tuples = (set((n.program, n.is_drum) for n in ref_ns.notes)
            | set((n.program, n.is_drum) for n in est_ns.notes))

  sums = collections.defaultdict(float)
  counts = collections.defaultdict(int)
  for program, is_drum in tuples:
    est_track = note_events.extract_track(est_ns, program, is_drum)
    ref_track = note_events.extract_track(ref_ns, program, is_drum)
    est_intervals, est_pitches, _ = sequence_to_valued_intervals(est_track)
    ref_intervals, ref_pitches, _ = sequence_to_valued_intervals(ref_track)

    kwargs = {}
    if is_drum:
      kwargs['offset_ratio'] = None
    precision, recall, _, _ = transcription.precision_recall_f1_overlap(
        ref_intervals, ref_pitches, est_intervals, est_pitches, **kwargs)

    key = 'drum' if is_drum else 'nondrum'
    sums[f'{key}_precision'] += precision * len(est_intervals)
    counts[f'{key}_precision'] += len(est_intervals)
    sums[f'{key}_recall'] += recall * len(ref_intervals)
    counts[f'{key}_recall'] += len(ref_intervals)

  def agg(keys):
    p_sum = sum(sums[f'{k}_precision'] for k in keys)
    p_count = sum(counts[f'{k}_precision'] for k in keys)
    r_sum = sum(sums[f'{k}_recall'] for k in keys)
    r_count = sum(counts[f'{k}_recall'] for k in keys)
    precision = p_sum / p_count if p_count else 0
    recall = r_sum / r_count if r_count else 0
    return precision, recall, transcription.f_measure(precision, recall)

  precision, recall, f1 = agg(['drum', 'nondrum'])
  drum_p, drum_r, drum_f = agg(['drum'])
  nondrum_p, nondrum_r, nondrum_f = agg(['nondrum'])

  g = granularity_type
  return {
      f'Onset + offset + program precision ({g})': precision,
      f'Onset + offset + program recall ({g})': recall,
      f'Onset + offset + program F1 ({g})': f1,
      f'Drum onset precision ({g})': drum_p,
      f'Drum onset recall ({g})': drum_r,
      f'Drum onset F1 ({g})': drum_f,
      f'Nondrum onset + offset + program precision ({g})': nondrum_p,
      f'Nondrum onset + offset + program recall ({g})': nondrum_r,
      f'Nondrum onset + offset + program F1 ({g})': nondrum_f,
  }


def _note_onset_tolerance_sweep(
    ref_ns: NoteSequence, est_ns: NoteSequence,
    tolerances: Iterable[float] = (0.01, 0.02, 0.05, 0.1, 0.2, 0.5)
) -> Mapping[str, float]:
  est_intervals, est_pitches, _ = sequence_to_valued_intervals(est_ns)
  ref_intervals, ref_pitches, _ = sequence_to_valued_intervals(ref_ns)
  scores = {}
  for tol in tolerances:
    precision, recall, f1, _ = transcription.precision_recall_f1_overlap(
        ref_intervals, ref_pitches, est_intervals, est_pitches,
        onset_tolerance=tol, offset_min_tolerance=tol)
    scores[f'Onset + offset precision ({tol})'] = precision
    scores[f'Onset + offset recall ({tol})'] = recall
    scores[f'Onset + offset F1 ({tol})'] = f1
  return scores


def _remove_drums(ns: NoteSequence) -> NoteSequence:
  out = ns.copy()
  out.notes = [note for note in out.notes if not note.is_drum]
  return out


# ---------------------------------------------------------------------------
# Top-level metric aggregation.
# ---------------------------------------------------------------------------
def transcription_metrics(
    targets: Sequence[Mapping[str, Any]],
    predictions: Sequence[Mapping[str, Any]],
    codec: event_codec.Codec,
    onsets_only: bool,
    use_ties: bool,
    track_specs: Optional[Sequence[note_events.TrackSpec]] = None,
    frame_fps: float = DEFAULT_FRAME_FPS,
    frame_velocity_threshold: int = DEFAULT_FRAME_VELOCITY_THRESHOLD,
    return_raw: bool = False,
) -> Mapping[str, float]:
  """Compute the full transcription metric family.

  targets: dicts with 'unique_id' and 'ref_ns'.
  predictions: segment dicts with 'unique_id', 'est_tokens', 'start_time'.
  Returns mean scores over examples (reference metrics.py:175-392, minus
  the TensorBoard audio/pianoroll summaries which live in eval/summaries).
  With return_raw, also returns the per-example score lists (the
  reference's histogram source data).
  """
  if onsets_only and use_ties:
    raise ValueError('Ties not compatible with onset-only transcription.')
  if onsets_only:
    encoding_spec = note_events.NoteOnsetEncodingSpec
  elif not use_ties:
    encoding_spec = note_events.NoteEncodingSpec
  else:
    encoding_spec = note_events.NoteEncodingWithTiesSpec

  full_targets = {}
  for target in targets:
    if target.get('ref_ns'):
      full_targets[target['unique_id']] = {'ref_ns': target['ref_ns']}

  full_predictions = postprocess.combine_predictions_by_id(
      predictions=predictions,
      combine_predictions_fn=functools.partial(
          postprocess.event_predictions_to_ns,
          codec=codec, encoding_spec=encoding_spec))

  if sorted(full_targets.keys()) != sorted(full_predictions.keys()):
    raise ValueError('target and prediction ids do not match')

  pairs = [(full_targets[uid], full_predictions[uid])
           for uid in sorted(full_targets.keys())]

  scores = collections.defaultdict(list)
  for target, prediction in pairs:
    scores['Invalid events'].append(prediction['est_invalid_events'])
    scores['Dropped events'].append(prediction['est_dropped_events'])

    est_ns_drumless = _remove_drums(prediction['est_ns'])
    ref_ns_drumless = _remove_drums(target['ref_ns'])

    est_tracks = [est_ns_drumless]
    ref_tracks = [ref_ns_drumless]
    use_track_offsets = [not onsets_only]
    use_track_velocities = [not onsets_only]
    track_instrument_names = ['']

    if track_specs is not None:
      for spec in track_specs:
        est_tracks.append(note_events.extract_track(
            prediction['est_ns'], spec.program, spec.is_drum))
        ref_tracks.append(note_events.extract_track(
            target['ref_ns'], spec.program, spec.is_drum))
        use_track_offsets.append(not onsets_only and not spec.is_drum)
        use_track_velocities.append(not onsets_only)
        track_instrument_names.append(spec.name)

    for est_ns, ref_ns, use_offsets, use_velocities, name in zip(
        est_tracks, ref_tracks, use_track_offsets, use_track_velocities,
        track_instrument_names):
      track_scores = {}
      est_intervals, est_pitches, est_velocities = (
          sequence_to_valued_intervals(est_ns))
      ref_intervals, ref_pitches, ref_velocities = (
          sequence_to_valued_intervals(ref_ns))

      p, r, f1, _ = transcription.precision_recall_f1_overlap(
          ref_intervals, ref_pitches, est_intervals, est_pitches,
          offset_ratio=None)
      track_scores['Onset precision'] = p
      track_scores['Onset recall'] = r
      track_scores['Onset F1'] = f1

      if use_offsets:
        p, r, f1, _ = transcription.precision_recall_f1_overlap(
            ref_intervals, ref_pitches, est_intervals, est_pitches)
        track_scores['Onset + offset precision'] = p
        track_scores['Onset + offset recall'] = r
        track_scores['Onset + offset F1'] = f1

      if use_velocities:
        p, r, f1, _ = transcription.precision_recall_f1_overlap_velocity(
            ref_intervals, ref_pitches, ref_velocities,
            est_intervals, est_pitches, est_velocities,
            offset_ratio=None)
        track_scores['Onset + velocity precision'] = p
        track_scores['Onset + velocity recall'] = r
        track_scores['Onset + velocity F1'] = f1

      if use_offsets and use_velocities:
        p, r, f1, _ = transcription.precision_recall_f1_overlap_velocity(
            ref_intervals, ref_pitches, ref_velocities,
            est_intervals, est_pitches, est_velocities)
        track_scores['Onset + offset + velocity precision'] = p
        track_scores['Onset + offset + velocity recall'] = r
        track_scores['Onset + offset + velocity F1'] = f1

      is_drum = all(n.is_drum for n in ref_ns.notes) if ref_ns.notes else (
          False)
      ref_pr = get_pianoroll(ref_ns, frame_fps, is_drum=is_drum)
      est_pr = get_pianoroll(est_ns, frame_fps, is_drum=is_drum)
      fp, fr, ff = frame_metrics(
          ref_pr, est_pr, velocity_threshold=frame_velocity_threshold)
      track_scores['Frame Precision'] = fp
      track_scores['Frame Recall'] = fr
      track_scores['Frame F1'] = ff

      for metric_name, metric_value in track_scores.items():
        key = f'{name}/{metric_name}' if name else metric_name
        scores[key].append(metric_value)

    for granularity_type in vocabulary.PROGRAM_GRANULARITIES:
      for metric_name, score in _program_aware_note_scores(
          target['ref_ns'], prediction['est_ns'],
          granularity_type=granularity_type).items():
        scores[metric_name].append(score)

    for metric_name, score in _note_onset_tolerance_sweep(
        ref_ns=ref_ns_drumless, est_ns=est_ns_drumless).items():
      scores[metric_name].append(score)

  means = {k: float(np.mean(v)) for k, v in scores.items()}
  if return_raw:
    return means, {k: list(map(float, v)) for k, v in scores.items()}
  return means
