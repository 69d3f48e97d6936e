"""Note transcription matching metrics (mir_eval-equivalent, self-contained).

Rebuild of the subset of mir_eval that the reference metrics use
(mt3/metrics.py): note matching by onset/pitch/offset with
maximum bipartite matching, plus the velocity-aware variant with global
least-squares velocity rescaling (mir_eval.transcription_velocity).

Pitch-unit note: the reference passes MIDI note numbers where mir_eval
documents Hz; the 50-cent default tolerance therefore compares *MIDI
numbers* as frequency ratios.  We reproduce that behavior exactly for
parity (|1200*log2(est/ref)| <= pitch_tolerance over the raw numbers).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching


def f_measure(precision: float, recall: float) -> float:
  if precision + recall == 0:
    return 0.0
  return 2.0 * precision * recall / (precision + recall)


def _hit_matrix(ref_intervals: np.ndarray, ref_pitches: np.ndarray,
                est_intervals: np.ndarray, est_pitches: np.ndarray,
                onset_tolerance: float, pitch_tolerance: float,
                offset_ratio: Optional[float],
                offset_min_tolerance: float) -> np.ndarray:
  """Boolean [n_ref, n_est] matrix of allowable matches."""
  onset_dist = np.abs(ref_intervals[:, 0][:, None]
                      - est_intervals[:, 0][None, :])
  hits = onset_dist <= onset_tolerance

  with np.errstate(divide='ignore', invalid='ignore'):
    pitch_dist = np.abs(1200.0 * np.log2(
        est_pitches[None, :].astype(np.float64)
        / ref_pitches[:, None].astype(np.float64)))
  hits &= pitch_dist <= pitch_tolerance

  if offset_ratio is not None:
    ref_durations = ref_intervals[:, 1] - ref_intervals[:, 0]
    offset_tol = np.maximum(offset_ratio * ref_durations,
                            offset_min_tolerance)
    offset_dist = np.abs(ref_intervals[:, 1][:, None]
                         - est_intervals[:, 1][None, :])
    hits &= offset_dist <= offset_tol[:, None]
  return hits


def match_notes(ref_intervals: np.ndarray, ref_pitches: np.ndarray,
                est_intervals: np.ndarray, est_pitches: np.ndarray,
                onset_tolerance: float = 0.05,
                pitch_tolerance: float = 50.0,
                offset_ratio: Optional[float] = 0.2,
                offset_min_tolerance: float = 0.05
                ) -> List[Tuple[int, int]]:
  """Maximum bipartite matching of ref and est notes."""
  if len(ref_pitches) == 0 or len(est_pitches) == 0:
    return []
  hits = _hit_matrix(ref_intervals, ref_pitches, est_intervals,
                     est_pitches, onset_tolerance, pitch_tolerance,
                     offset_ratio, offset_min_tolerance)
  if not hits.any():
    return []
  graph = csr_matrix(hits)
  # perm[j] = matched ref index for est j, or -1.
  perm = maximum_bipartite_matching(graph, perm_type='row')
  return [(int(perm[j]), j) for j in range(len(est_pitches))
          if perm[j] >= 0]


def precision_recall_f1_overlap(
    ref_intervals: np.ndarray, ref_pitches: np.ndarray,
    est_intervals: np.ndarray, est_pitches: np.ndarray,
    onset_tolerance: float = 0.05, pitch_tolerance: float = 50.0,
    offset_ratio: Optional[float] = 0.2,
    offset_min_tolerance: float = 0.05
) -> Tuple[float, float, float, float]:
  """Returns (precision, recall, f1, avg_overlap_ratio)."""
  if len(ref_pitches) == 0 and len(est_pitches) == 0:
    return 0.0, 0.0, 0.0, 0.0
  matching = match_notes(ref_intervals, ref_pitches, est_intervals,
                         est_pitches, onset_tolerance, pitch_tolerance,
                         offset_ratio, offset_min_tolerance)
  precision = len(matching) / len(est_pitches) if len(est_pitches) else 0.0
  recall = len(matching) / len(ref_pitches) if len(ref_pitches) else 0.0

  avg_overlap = 0.0
  if matching:
    ratios = []
    for i, j in matching:
      intersection = (min(ref_intervals[i, 1], est_intervals[j, 1])
                      - max(ref_intervals[i, 0], est_intervals[j, 0]))
      union = (max(ref_intervals[i, 1], est_intervals[j, 1])
               - min(ref_intervals[i, 0], est_intervals[j, 0]))
      ratios.append(intersection / union if union > 0 else 0.0)
    avg_overlap = float(np.mean(ratios))
  return precision, recall, f_measure(precision, recall), avg_overlap


def match_notes_with_velocity(
    ref_intervals, ref_pitches, ref_velocities,
    est_intervals, est_pitches, est_velocities,
    onset_tolerance: float = 0.05, pitch_tolerance: float = 50.0,
    offset_ratio: Optional[float] = 0.2,
    offset_min_tolerance: float = 0.05,
    velocity_tolerance: float = 0.1) -> List[Tuple[int, int]]:
  """Velocity-aware matching (mir_eval.transcription_velocity semantics).

  Notes are matched ignoring velocity; estimated velocities are then
  globally rescaled to the reference via least squares, reference
  velocities are normalized to [0, 1], and matches with absolute velocity
  error >= velocity_tolerance are discarded.
  """
  matching = match_notes(ref_intervals, ref_pitches, est_intervals,
                         est_pitches, onset_tolerance, pitch_tolerance,
                         offset_ratio, offset_min_tolerance)
  if not matching:
    return []
  ref_velocities = np.asarray(ref_velocities, np.float64)
  est_velocities = np.asarray(est_velocities, np.float64)

  min_v, max_v = ref_velocities.min(), ref_velocities.max()
  velocity_range = max(1.0, max_v - min_v)
  ref_norm = (ref_velocities - min_v) / velocity_range

  matching_arr = np.array(matching)
  ref_matched = ref_norm[matching_arr[:, 0]]
  est_matched = est_velocities[matching_arr[:, 1]]
  design = np.vstack([est_matched, np.ones(len(est_matched))]).T
  slope, intercept = np.linalg.lstsq(design, ref_matched, rcond=None)[0]
  est_rescaled = slope * est_matched + intercept

  keep = np.abs(est_rescaled - ref_matched) < velocity_tolerance
  return [tuple(m) for m in matching_arr[keep]]


def precision_recall_f1_overlap_velocity(
    ref_intervals, ref_pitches, ref_velocities,
    est_intervals, est_pitches, est_velocities,
    onset_tolerance: float = 0.05, pitch_tolerance: float = 50.0,
    offset_ratio: Optional[float] = 0.2,
    offset_min_tolerance: float = 0.05,
    velocity_tolerance: float = 0.1
) -> Tuple[float, float, float, float]:
  if len(ref_pitches) == 0 and len(est_pitches) == 0:
    return 0.0, 0.0, 0.0, 0.0
  matching = match_notes_with_velocity(
      ref_intervals, ref_pitches, ref_velocities, est_intervals,
      est_pitches, est_velocities, onset_tolerance, pitch_tolerance,
      offset_ratio, offset_min_tolerance, velocity_tolerance)
  precision = len(matching) / len(est_pitches) if len(est_pitches) else 0.0
  recall = len(matching) / len(ref_pitches) if len(ref_pitches) else 0.0
  return precision, recall, f_measure(precision, recall), 0.0
