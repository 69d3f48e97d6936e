"""Per-dataset instrument-name -> MIDI program lookup and multi-track
tokenization helpers.

Rebuild of the dataset-specific tokenizers in
mt3/preprocessors.py:229-608: GuitarSet / URMP program
lookup tables, Slakh class mapping, and the multi-track assembly path
(per-track sustain application, program/drum assignment, pitch-bend
rejection, train-time overlap trimming).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from mt3_tpu_torch.codec import event_codec, note_events
from mt3_tpu_torch.core import sustain
from mt3_tpu_torch.core.config import SpectrogramConfig
from mt3_tpu_torch.core.note_sequence import NoteSequence
from mt3_tpu_torch.data import pipeline


def guitarset_instrument_to_program(instrument: str) -> int:
  """GuitarSet is all guitar; first MIDI guitar program."""
  if instrument == 'Clean Guitar':
    return 24
  raise ValueError('Unknown GuitarSet instrument: %s' % instrument)


_URMP_INSTRUMENT_PROGRAMS = {
    'vn': 40,   # violin
    'va': 41,   # viola
    'vc': 42,   # cello
    'db': 43,   # double bass
    'tpt': 56,  # trumpet
    'tbn': 57,  # trombone
    'tba': 58,  # tuba
    'hn': 60,   # French horn
    'sax': 64,  # saxophone
    'ob': 68,   # oboe
    'bn': 70,   # bassoon
    'cl': 71,   # clarinet
    'fl': 73,   # flute
}


def urmp_instrument_to_program(urmp_instrument: str) -> int:
  if urmp_instrument not in _URMP_INSTRUMENT_PROGRAMS:
    raise ValueError('unknown URMP instrument: %s' % urmp_instrument)
  return _URMP_INSTRUMENT_PROGRAMS[urmp_instrument]


_SLAKH_CLASS_PROGRAMS = {
    'Acoustic Piano': 0,
    'Electric Piano': 4,
    'Chromatic Percussion': 8,
    'Organ': 16,
    'Acoustic Guitar': 24,
    'Clean Electric Guitar': 26,
    'Distorted Electric Guitar': 29,
    'Acoustic Bass': 32,
    'Electric Bass': 33,
    'Violin': 40,
    'Viola': 41,
    'Cello': 42,
    'Contrabass': 43,
    'Orchestral Harp': 46,
    'Timpani': 47,
    'String Ensemble': 48,
    'Synth Strings': 50,
    'Choir and Voice': 52,
    'Orchestral Hit': 55,
    'Trumpet': 56,
    'Trombone': 57,
    'Tuba': 58,
    'French Horn': 60,
    'Brass Section': 61,
    'Soprano/Alto Sax': 64,
    'Tenor Sax': 66,
    'Baritone Sax': 67,
    'Oboe': 68,
    'English Horn': 69,
    'Bassoon': 70,
    'Clarinet': 71,
    'Pipe': 73,
    'Synth Lead': 80,
    'Synth Pad': 88,
}


def slakh_class_to_program_and_is_drum(slakh_class: str
                                       ) -> Tuple[int, bool]:
  if slakh_class == 'Drums':
    return 0, True
  if slakh_class not in _SLAKH_CLASS_PROGRAMS:
    raise ValueError('unknown Slakh class: %s' % slakh_class)
  return _SLAKH_CLASS_PROGRAMS[slakh_class], False


class PitchBendError(Exception):
  pass


def add_track_to_notesequence(ns: NoteSequence, track: NoteSequence,
                              program: int, is_drum: bool,
                              ignore_pitch_bends: bool) -> None:
  """Apply sustain to a track and merge it into ns with program/drum set."""
  if track.pitch_bends and not ignore_pitch_bends:
    raise PitchBendError
  track_sus = sustain.apply_sustain_control_changes(track)
  for note in track_sus.notes:
    note.program = program
    note.is_drum = is_drum
    ns.notes.append(note)
    ns.total_time = max(ns.total_time, note.end_time)


def assemble_multitrack(
    tracks: Sequence[NoteSequence],
    inst_names: Sequence[str],
    inst_name_to_program_fn: Optional[Callable[[str], int]] = None,
    track_specs: Optional[Sequence[note_events.TrackSpec]] = None,
    slakh_classes: bool = False,
    is_training_data: bool = False,
    ignore_pitch_bends: bool = True,
) -> Optional[NoteSequence]:
  """Merge per-instrument tracks into one NoteSequence.

  Program/drum assignment comes from track_specs (Cerberus4-style), Slakh
  class names, or an instrument-name lookup.  Returns None if a track has
  pitch bends and they are not ignored (the reference drops such
  examples, preprocessors.py:520-534).
  """
  ns = NoteSequence(ticks_per_quarter=220)
  assert len(tracks) == len(inst_names)
  try:
    if track_specs is not None:
      assert len(tracks) == len(track_specs)
      for track, spec, inst_name in zip(tracks, track_specs, inst_names):
        assert inst_name == spec.name
        add_track_to_notesequence(ns, track, program=spec.program,
                                  is_drum=spec.is_drum,
                                  ignore_pitch_bends=ignore_pitch_bends)
    elif slakh_classes:
      for track, inst_name in zip(tracks, inst_names):
        program, is_drum = slakh_class_to_program_and_is_drum(inst_name)
        add_track_to_notesequence(ns, track, program=program,
                                  is_drum=is_drum,
                                  ignore_pitch_bends=ignore_pitch_bends)
    else:
      for track, inst_name in zip(tracks, inst_names):
        program = inst_name_to_program_fn(inst_name)
        add_track_to_notesequence(ns, track, program=program,
                                  is_drum=False,
                                  ignore_pitch_bends=ignore_pitch_bends)
  except PitchBendError:
    return None

  note_events.assign_instruments(ns)
  note_events.validate_note_sequence(ns)
  if is_training_data:
    # The event vocabulary cannot represent overlapping same-pitch notes;
    # trim for training but keep originals for eval.
    ns = note_events.trim_overlapping_notes(ns)
  return ns


def tokenize_multitrack_example(
    tracks: Sequence[NoteSequence],
    inst_names: Sequence[str],
    samples: np.ndarray,
    spectrogram_config: SpectrogramConfig,
    codec: event_codec.Codec,
    is_training_data: bool = False,
    onsets_only: bool = False,
    include_ties: bool = True,
    inst_name_to_program_fn: Optional[Callable[[str], int]] = None,
    track_specs: Optional[Sequence[note_events.TrackSpec]] = None,
    slakh_classes: bool = False,
    ignore_pitch_bends: bool = True,
):
  """Multi-track analog of pipeline.tokenize_example; None if dropped."""
  ns = assemble_multitrack(
      tracks, inst_names,
      inst_name_to_program_fn=inst_name_to_program_fn,
      track_specs=track_specs, slakh_classes=slakh_classes,
      is_training_data=is_training_data,
      ignore_pitch_bends=ignore_pitch_bends)
  if ns is None:
    return None
  # Sustain already applied per track.
  return pipeline.tokenize_example(
      ns, samples, spectrogram_config, codec, onsets_only=onsets_only,
      include_ties=include_ties, apply_sustain=False)
