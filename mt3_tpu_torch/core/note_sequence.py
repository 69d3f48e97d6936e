"""Self-contained NoteSequence data model.

The reference depends on the `note_seq` package's NoteSequence protobuf.
That dependency is not available here, and the rebuild is dependency-free on
the host side too: this module provides a plain-Python equivalent carrying
exactly the fields MT3 touches (notes, control changes, tempos, total_time,
id/filename/ticks_per_quarter).

Reference usage surface: mt3/note_sequences.py,
preprocessors.py:154 (apply_sustain_control_changes),
metrics.py:87-89 (sequence_to_valued_intervals).
"""

from __future__ import annotations

import copy as _copy
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

STANDARD_PPQ = 220


@dataclasses.dataclass
class Note:
  pitch: int
  velocity: int
  start_time: float
  end_time: float
  program: int = 0
  is_drum: bool = False
  instrument: int = 0


@dataclasses.dataclass
class ControlChange:
  time: float
  control_number: int
  control_value: int
  program: int = 0
  is_drum: bool = False
  instrument: int = 0


@dataclasses.dataclass
class TempoChange:
  time: float = 0.0
  qpm: float = 120.0


@dataclasses.dataclass
class PitchBend:
  time: float
  bend: int
  program: int = 0
  is_drum: bool = False
  instrument: int = 0


@dataclasses.dataclass
class NoteSequence:
  """A sequence of notes; plain-Python analog of the note_seq proto."""
  notes: List[Note] = dataclasses.field(default_factory=list)
  control_changes: List[ControlChange] = dataclasses.field(
      default_factory=list)
  tempos: List[TempoChange] = dataclasses.field(default_factory=list)
  pitch_bends: List[PitchBend] = dataclasses.field(default_factory=list)
  total_time: float = 0.0
  ticks_per_quarter: int = STANDARD_PPQ
  id: str = ''
  filename: str = ''
  source_sample_rate: int = 0

  def copy(self) -> 'NoteSequence':
    return _copy.deepcopy(self)

  def add_note(self, **kwargs) -> Note:
    note = Note(**kwargs)
    self.notes.append(note)
    return note

  def sorted_notes(self) -> List[Note]:
    return sorted(
        self.notes,
        key=lambda n: (n.start_time, n.end_time, n.pitch, n.velocity))

  def __eq__(self, other) -> bool:
    if not isinstance(other, NoteSequence):
      return NotImplemented
    return (self.sorted_notes() == other.sorted_notes()
            and abs(self.total_time - other.total_time) < 1e-9)


def sequences_approx_equal(a: NoteSequence, b: NoteSequence,
                           time_tol: float = 1e-6) -> bool:
  """Compare note content with a floating-point time tolerance."""
  an, bn = a.sorted_notes(), b.sorted_notes()
  if len(an) != len(bn):
    return False
  for x, y in zip(an, bn):
    if (x.pitch != y.pitch or x.velocity != y.velocity
        or x.program != y.program or x.is_drum != y.is_drum
        or abs(x.start_time - y.start_time) > time_tol
        or abs(x.end_time - y.end_time) > time_tol):
      return False
  return True


def sequence_to_valued_intervals(
    ns: NoteSequence,
    restrict_to_pitch: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Convert a NoteSequence to (intervals, pitches, velocities) arrays.

  Equivalent to note_seq.sequences_lib.sequence_to_valued_intervals as used
  by the reference metrics (mt3/metrics.py:87-89): zero-length
  notes are dropped.
  """
  intervals, pitches, velocities = [], [], []
  for note in ns.notes:
    if restrict_to_pitch is not None and note.pitch != restrict_to_pitch:
      continue
    if note.end_time <= note.start_time:
      continue
    intervals.append((note.start_time, note.end_time))
    pitches.append(note.pitch)
    velocities.append(note.velocity)
  intervals = np.array(intervals, dtype=np.float64).reshape(-1, 2)
  return intervals, np.array(pitches, dtype=np.int64), np.array(
      velocities, dtype=np.int64)
