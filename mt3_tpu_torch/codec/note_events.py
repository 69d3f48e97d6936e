"""Note-event encoding/decoding state machines over NoteSequences.

Capability-parity rebuild of mt3/note_sequences.py: extract
timed note events from a NoteSequence for encoding, and replay decoded
events (onset / offset / velocity / program / drum / tie) back into a
NoteSequence, including the tie-section mechanism that carries active notes
across segment boundaries.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import MutableMapping, MutableSet, Optional, Sequence, Tuple

from mt3_tpu_torch.codec import event_codec, run_length, vocabulary
from mt3_tpu_torch.core.note_sequence import Note, NoteSequence

Event = event_codec.Event

DEFAULT_VELOCITY = 100
DEFAULT_NOTE_DURATION = 0.01

# Quantization can produce zero-length notes; enforce a minimum duration.
MIN_NOTE_DURATION = 0.01


@dataclasses.dataclass
class TrackSpec:
  name: str
  program: int = 0
  is_drum: bool = False


def extract_track(ns: NoteSequence, program: int,
                  is_drum: bool) -> NoteSequence:
  """Single-(program, is_drum) view of a NoteSequence.

  Parity: mt3/note_sequences.py:42-49.
  """
  # Copies, matching the reference's proto-extend copy semantics.
  selected = [dataclasses.replace(n) for n in ns.notes
              if (n.program, n.is_drum) == (program, is_drum)]
  return NoteSequence(
      ticks_per_quarter=220,
      notes=selected,
      total_time=max((n.end_time for n in selected), default=0.0))


def trim_overlapping_notes(ns: NoteSequence) -> NoteSequence:
  """Clip each note at the onset of its channel's next note.

  Within every (pitch, program, is_drum) channel, a note still sounding
  when the channel's next onset arrives is clipped to that onset; notes
  left without positive duration are dropped.
  Parity: mt3/note_sequences.py:52-69.
  """
  out = ns.copy()
  by_channel = collections.defaultdict(list)
  for note in out.notes:
    by_channel[note.pitch, note.program, note.is_drum].append(note)
  for channel_notes in by_channel.values():
    channel_notes.sort(key=lambda n: n.start_time)
    for prev, nxt in zip(channel_notes, channel_notes[1:]):
      prev.end_time = min(prev.end_time, nxt.start_time)
  out.notes = [n for n in out.notes if n.end_time > n.start_time]
  return out


def assign_instruments(ns: NoteSequence) -> None:
  """Assign instrument numbers (drums -> 9, skip 9 otherwise); in place."""
  program_instruments = {}
  for note in ns.notes:
    if note.program not in program_instruments and not note.is_drum:
      num_instruments = len(program_instruments)
      note.instrument = (num_instruments if num_instruments < 9
                         else num_instruments + 1)
      program_instruments[note.program] = note.instrument
    elif note.is_drum:
      note.instrument = 9
    else:
      note.instrument = program_instruments[note.program]


def validate_note_sequence(ns: NoteSequence) -> None:
  """Raise ValueError on invalid notes."""
  for note in ns.notes:
    if note.start_time >= note.end_time:
      raise ValueError('note has start time >= end time: %f >= %f' %
                       (note.start_time, note.end_time))
    if note.velocity == 0:
      raise ValueError('note has zero velocity')


@dataclasses.dataclass
class NoteEventData:
  pitch: int
  velocity: Optional[int] = None
  program: Optional[int] = None
  is_drum: Optional[bool] = None
  instrument: Optional[int] = None


def note_sequence_to_onsets(
    ns: NoteSequence) -> Tuple[Sequence[float], Sequence[NoteEventData]]:
  """Onset times and pitches only."""
  # Sort by pitch as a tiebreaker for the subsequent stable time sort.
  notes = sorted(ns.notes, key=lambda note: note.pitch)
  return ([note.start_time for note in notes],
          [NoteEventData(pitch=note.pitch) for note in notes])


def note_sequence_to_onsets_and_offsets(
    ns: NoteSequence) -> Tuple[Sequence[float], Sequence[NoteEventData]]:
  """Onsets and offsets (velocity zero marks an offset)."""
  # Sort by pitch, offsets before onsets, as stable-sort tiebreakers.
  notes = sorted(ns.notes, key=lambda note: note.pitch)
  times = ([note.end_time for note in notes]
           + [note.start_time for note in notes])
  values = ([NoteEventData(pitch=note.pitch, velocity=0) for note in notes]
            + [NoteEventData(pitch=note.pitch, velocity=note.velocity)
               for note in notes])
  return times, values


def note_sequence_to_onsets_and_offsets_and_programs(
    ns: NoteSequence) -> Tuple[Sequence[float], Sequence[NoteEventData]]:
  """Onsets and offsets with programs; drums are onset-only."""
  # Sort by (is_drum, program, pitch), offsets first, as tiebreakers.
  notes = sorted(ns.notes,
                 key=lambda note: (note.is_drum, note.program, note.pitch))
  times = ([note.end_time for note in notes if not note.is_drum]
           + [note.start_time for note in notes])
  values = ([NoteEventData(pitch=note.pitch, velocity=0,
                           program=note.program, is_drum=False)
             for note in notes if not note.is_drum]
            + [NoteEventData(pitch=note.pitch, velocity=note.velocity,
                             program=note.program, is_drum=note.is_drum)
               for note in notes])
  return times, values


@dataclasses.dataclass
class NoteEncodingState:
  """Encoding state: velocity bin for active (pitch, program) pairs."""
  active_pitches: MutableMapping[Tuple[int, int], int] = dataclasses.field(
      default_factory=dict)


def note_event_data_to_events(
    state: Optional[NoteEncodingState],
    value: NoteEventData,
    codec: event_codec.Codec,
) -> Sequence[Event]:
  """Convert note event data to a sequence of codec events."""
  if value.velocity is None:
    # Onsets only: no program or velocity.
    return [Event('pitch', value.pitch)]
  num_velocity_bins = vocabulary.num_velocity_bins_from_codec(codec)
  velocity_bin = vocabulary.velocity_to_bin(value.velocity,
                                            num_velocity_bins)
  if value.program is None:
    # Onsets + offsets + velocities, no programs.
    if state is not None:
      state.active_pitches[(value.pitch, 0)] = velocity_bin
    return [Event('velocity', velocity_bin), Event('pitch', value.pitch)]
  if value.is_drum:
    # Drum events use a separate vocabulary.
    return [Event('velocity', velocity_bin), Event('drum', value.pitch)]
  # Program + velocity + pitch.
  if state is not None:
    state.active_pitches[(value.pitch, int(value.program))] = velocity_bin
  return [Event('program', value.program),
          Event('velocity', velocity_bin),
          Event('pitch', value.pitch)]


def note_encoding_state_to_events(
    state: NoteEncodingState) -> Sequence[Event]:
  """Program/pitch events for active notes plus the final tie event."""
  events = []
  for pitch, program in sorted(state.active_pitches.keys(),
                               key=lambda k: k[::-1]):
    if state.active_pitches[(pitch, program)]:
      events += [Event('program', program), Event('pitch', pitch)]
  events.append(Event('tie', 0))
  return events


@dataclasses.dataclass
class NoteDecodingState:
  """Decoding state for note transcription."""
  current_time: float = 0.0
  # Velocity applied to subsequent pitch events (zero = note-off).
  current_velocity: int = DEFAULT_VELOCITY
  current_program: int = 0
  # (pitch, program) -> (onset time, velocity) for active notes.
  active_pitches: MutableMapping[Tuple[int, int],
                                 Tuple[float, int]] = dataclasses.field(
                                     default_factory=dict)
  # Pitches (with programs) continued from the previous segment.
  tied_pitches: MutableSet[Tuple[int, int]] = dataclasses.field(
      default_factory=set)
  is_tie_section: bool = False
  note_sequence: NoteSequence = dataclasses.field(
      default_factory=lambda: NoteSequence(ticks_per_quarter=220))


def decode_note_onset_event(
    state: NoteDecodingState, time: float, event: Event,
    codec: event_codec.Codec) -> None:
  """Process an onset-only event."""
  del codec
  if event.type == 'pitch':
    state.note_sequence.notes.append(Note(
        pitch=event.value, velocity=DEFAULT_VELOCITY,
        start_time=time, end_time=time + DEFAULT_NOTE_DURATION))
    state.note_sequence.total_time = max(
        state.note_sequence.total_time, time + DEFAULT_NOTE_DURATION)
  else:
    raise ValueError('unexpected event type: %s' % event.type)


def _add_note_to_sequence(ns: NoteSequence, start_time: float,
                          end_time: float, pitch: int, velocity: int,
                          program: int = 0, is_drum: bool = False) -> None:
  end_time = max(end_time, start_time + MIN_NOTE_DURATION)
  ns.notes.append(Note(
      pitch=pitch, velocity=velocity, start_time=start_time,
      end_time=end_time, program=program, is_drum=is_drum))
  ns.total_time = max(ns.total_time, end_time)


def _finish_active_note(state: NoteDecodingState, key: Tuple[int, int],
                        end_time: float) -> None:
  """Pop (pitch, program) from the active set and emit its note."""
  started_at, velocity = state.active_pitches.pop(key)
  pitch, program = key
  _add_note_to_sequence(
      state.note_sequence, start_time=started_at, end_time=end_time,
      pitch=pitch, velocity=velocity, program=program)


def _on_pitch(state: NoteDecodingState, time: float, pitch: int,
              codec: event_codec.Codec) -> None:
  """A pitch token: tie declaration, note-off, or note-on.

  Which of the three depends on decoder state: inside a tie section it
  declares the pitch as carried over; otherwise current_velocity selects
  note-off (0) vs note-on.  A note-on for an already-active pitch closes
  the old note first (graceful re-onset).
  """
  del codec
  key = (pitch, state.current_program)
  if state.is_tie_section:
    if key not in state.active_pitches:
      raise ValueError(
          'tie declared for note that is not active: %s' % (key,))
    if key in state.tied_pitches:
      raise ValueError('tie declared twice for note: %s' % (key,))
    state.tied_pitches.add(key)
    return
  is_active = key in state.active_pitches
  if state.current_velocity == 0 and not is_active:
    raise ValueError('note-off for note that is not active: %s' % (key,))
  if is_active:
    _finish_active_note(state, key, time)
  if state.current_velocity > 0:
    state.active_pitches[key] = (time, state.current_velocity)


def _on_drum(state: NoteDecodingState, time: float, pitch: int,
             codec: event_codec.Codec) -> None:
  """A drum hit: fixed short duration, never enters the active set."""
  del codec
  if state.current_velocity == 0:
    raise ValueError('drum event requires nonzero velocity')
  _add_note_to_sequence(
      state.note_sequence, start_time=time,
      end_time=time + DEFAULT_NOTE_DURATION,
      pitch=pitch, velocity=state.current_velocity, is_drum=True)


def _on_velocity(state: NoteDecodingState, time: float, velocity_bin: int,
                 codec: event_codec.Codec) -> None:
  del time
  bins = vocabulary.num_velocity_bins_from_codec(codec)
  state.current_velocity = vocabulary.bin_to_velocity(velocity_bin, bins)


def _on_program(state: NoteDecodingState, time: float, program: int,
                codec: event_codec.Codec) -> None:
  del time, codec
  state.current_program = program


def _on_tie(state: NoteDecodingState, time: float, value: int,
            codec: event_codec.Codec) -> None:
  """End-of-tie-section marker: any active note NOT re-declared ends now."""
  del value, codec
  if not state.is_tie_section:
    raise ValueError('tie marker outside of a tie section')
  for key in [k for k in state.active_pitches if k not in state.tied_pitches]:
    _finish_active_note(state, key, time)
  state.is_tie_section = False


_NOTE_EVENT_HANDLERS = {
    'pitch': _on_pitch,
    'drum': _on_drum,
    'velocity': _on_velocity,
    'program': _on_program,
    'tie': _on_tie,
}


def decode_note_event(
    state: NoteDecodingState, time: float, event: Event,
    codec: event_codec.Codec) -> None:
  """Process a note event, updating the decoding state.

  Dispatch-table state machine over onset / offset / velocity / program /
  drum / tie events, with graceful re-onset handling and tie-section
  validation.  Capability parity with reference
  note_sequences.py:313-387 (contract pinned by tests/test_note_events.py).
  """
  if time < state.current_time:
    raise ValueError('event time %f precedes decoder clock %f' %
                     (time, state.current_time))
  state.current_time = time
  try:
    handler = _NOTE_EVENT_HANDLERS[event.type]
  except KeyError:
    raise ValueError('no decoder for event type: %s' % event.type) from None
  handler(state, time, event.value, codec)


def begin_tied_pitches_section(state: NoteDecodingState) -> None:
  state.tied_pitches = set()
  state.is_tie_section = True


def flush_note_decoding_state(state: NoteDecodingState) -> NoteSequence:
  """End all active notes and return the resulting NoteSequence."""
  for onset_time, _ in state.active_pitches.values():
    state.current_time = max(state.current_time,
                             onset_time + MIN_NOTE_DURATION)
  for (pitch, program) in list(state.active_pitches.keys()):
    onset_time, onset_velocity = state.active_pitches.pop((pitch, program))
    _add_note_to_sequence(
        state.note_sequence, start_time=onset_time,
        end_time=state.current_time, pitch=pitch, velocity=onset_velocity,
        program=program)
  assign_instruments(state.note_sequence)
  return state.note_sequence


class NoteEncodingSpecType(run_length.EventEncodingSpec):
  pass


# Onsets only.
NoteOnsetEncodingSpec = NoteEncodingSpecType(
    init_encoding_state_fn=lambda: None,
    encode_event_fn=note_event_data_to_events,
    encoding_state_to_events_fn=None,
    init_decoding_state_fn=NoteDecodingState,
    begin_decoding_segment_fn=lambda state: None,
    decode_event_fn=decode_note_onset_event,
    flush_decoding_state_fn=lambda state: state.note_sequence)

# Onsets + offsets (+ velocities, programs).
NoteEncodingSpec = NoteEncodingSpecType(
    init_encoding_state_fn=lambda: None,
    encode_event_fn=note_event_data_to_events,
    encoding_state_to_events_fn=None,
    init_decoding_state_fn=NoteDecodingState,
    begin_decoding_segment_fn=lambda state: None,
    decode_event_fn=decode_note_event,
    flush_decoding_state_fn=flush_note_decoding_state)

# Onsets + offsets with a tie section at the start of each segment.
NoteEncodingWithTiesSpec = NoteEncodingSpecType(
    init_encoding_state_fn=NoteEncodingState,
    encode_event_fn=note_event_data_to_events,
    encoding_state_to_events_fn=note_encoding_state_to_events,
    init_decoding_state_fn=NoteDecodingState,
    begin_decoding_segment_fn=begin_tied_pitches_section,
    decode_event_fn=decode_note_event,
    flush_decoding_state_fn=flush_note_decoding_state)
