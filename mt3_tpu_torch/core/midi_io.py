"""Pure-Python Standard MIDI File (SMF) reader / writer.

Replaces the reference's note_seq/pretty_midi MIDI I/O
(note_seq.midi_to_note_sequence / note_sequence_to_midi_file) with a
dependency-free implementation: NoteSequence <-> .mid bytes.

Reading handles format 0/1 files: tempo map (meta 0x51) for tick->seconds
conversion, note on/off pairing per (channel, pitch), control changes,
program changes, and running status.  Writing emits a format-1 file with one
tempo track plus one track per instrument.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

from mt3_tpu_torch.core.note_sequence import (ControlChange, Note, NoteSequence,
                                        PitchBend, TempoChange)

DEFAULT_QPM = 120.0
DRUM_CHANNEL = 9


# ---------------------------------------------------------------------------
# Varint helpers
# ---------------------------------------------------------------------------
def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
  value = 0
  while True:
    b = data[pos]
    pos += 1
    value = (value << 7) | (b & 0x7F)
    if not b & 0x80:
      return value, pos


def _write_varint(value: int) -> bytes:
  out = [value & 0x7F]
  value >>= 7
  while value:
    out.append(0x80 | (value & 0x7F))
    value >>= 7
  return bytes(reversed(out))


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------
def _parse_track(data: bytes) -> List[Tuple[int, bytes]]:
  """Parse one MTrk chunk into a list of (abs_tick, event_bytes)."""
  events = []
  pos = 0
  tick = 0
  running_status = None
  while pos < len(data):
    delta, pos = _read_varint(data, pos)
    tick += delta
    status = data[pos]
    if status < 0x80:
      if running_status is None:
        raise ValueError('Running status without prior status byte')
      status = running_status
    else:
      pos += 1
    if status == 0xFF:  # meta
      meta_type = data[pos]
      pos += 1
      length, pos = _read_varint(data, pos)
      payload = data[pos:pos + length]
      pos += length
      events.append((tick, bytes([status, meta_type]) + payload))
      running_status = None
    elif status in (0xF0, 0xF7):  # sysex
      length, pos = _read_varint(data, pos)
      pos += length
      running_status = None
    else:
      kind = status & 0xF0
      n_data = 1 if kind in (0xC0, 0xD0) else 2
      payload = data[pos:pos + n_data]
      pos += n_data
      events.append((tick, bytes([status]) + payload))
      running_status = status
  return events


class _TempoMap:
  """Tick -> seconds conversion under a piecewise-constant tempo map."""

  def __init__(self, ppq: int, tempo_events: List[Tuple[int, int]]):
    # tempo_events: (abs_tick, microseconds_per_quarter), sorted.
    self.ppq = ppq
    self.ticks = [0]
    self.times = [0.0]
    self.uspq = [500000]
    for tick, uspq in sorted(tempo_events):
      if tick == self.ticks[-1]:
        self.uspq[-1] = uspq
        continue
      dt = (tick - self.ticks[-1]) * self.uspq[-1] / (1e6 * ppq)
      self.ticks.append(tick)
      self.times.append(self.times[-1] + dt)
      self.uspq.append(uspq)

  def time(self, tick: int) -> float:
    import bisect
    i = bisect.bisect_right(self.ticks, tick) - 1
    return self.times[i] + (tick - self.ticks[i]) * self.uspq[i] / (
        1e6 * self.ppq)


def midi_to_note_sequence(midi_bytes: bytes) -> NoteSequence:
  """Parse SMF bytes into a NoteSequence (times in seconds)."""
  if midi_bytes[:4] != b'MThd':
    raise ValueError('Not a MIDI file (missing MThd)')
  header_len = int.from_bytes(midi_bytes[4:8], 'big')
  fmt = int.from_bytes(midi_bytes[8:10], 'big')
  n_tracks = int.from_bytes(midi_bytes[10:12], 'big')
  division = int.from_bytes(midi_bytes[12:14], 'big')
  if division & 0x8000:
    raise ValueError('SMPTE time division not supported')
  ppq = division
  del fmt

  pos = 8 + header_len
  tracks = []
  for _ in range(n_tracks):
    if midi_bytes[pos:pos + 4] != b'MTrk':
      raise ValueError('Expected MTrk chunk')
    length = int.from_bytes(midi_bytes[pos + 4:pos + 8], 'big')
    tracks.append(_parse_track(midi_bytes[pos + 8:pos + 8 + length]))
    pos += 8 + length

  tempo_events = []
  for track in tracks:
    for tick, ev in track:
      if ev[0] == 0xFF and ev[1] == 0x51:
        tempo_events.append((tick, int.from_bytes(ev[2:5], 'big')))
  tempo_map = _TempoMap(ppq, tempo_events)

  ns = NoteSequence(ticks_per_quarter=ppq)
  for tick, uspq in sorted(tempo_events):
    ns.tempos.append(TempoChange(time=tempo_map.time(tick), qpm=6e7 / uspq))
  if not ns.tempos:
    ns.tempos.append(TempoChange(time=0.0, qpm=120.0))

  instrument_counter = 0
  for track in tracks:
    channel_program: Dict[int, int] = collections.defaultdict(int)
    # (channel, pitch) -> list of (start_time, velocity, program, instrument)
    active: Dict[Tuple[int, int], List[Tuple[float, int, int, int]]] = (
        collections.defaultdict(list))
    channel_instrument: Dict[int, int] = {}

    def instrument_for(channel: int) -> int:
      nonlocal instrument_counter
      if channel not in channel_instrument:
        channel_instrument[channel] = instrument_counter
        instrument_counter += 1
      return channel_instrument[channel]

    for tick, ev in track:
      status = ev[0]
      if status == 0xFF:
        continue
      kind = status & 0xF0
      channel = status & 0x0F
      time = tempo_map.time(tick)
      if kind == 0xC0:
        channel_program[channel] = ev[1]
      elif kind == 0x90 and ev[2] > 0:
        active[(channel, ev[1])].append(
            (time, ev[2], channel_program[channel], instrument_for(channel)))
      elif kind == 0x80 or (kind == 0x90 and ev[2] == 0):
        starts = active.get((channel, ev[1]))
        if starts:
          start_time, velocity, program, instrument = starts.pop(0)
          if time > start_time:
            ns.notes.append(Note(
                pitch=ev[1], velocity=velocity, start_time=start_time,
                end_time=time, program=program,
                is_drum=(channel == DRUM_CHANNEL), instrument=instrument))
      elif kind == 0xB0:
        ns.control_changes.append(ControlChange(
            time=time, control_number=ev[1], control_value=ev[2],
            program=channel_program[channel],
            is_drum=(channel == DRUM_CHANNEL),
            instrument=instrument_for(channel)))
      elif kind == 0xE0:
        bend = ((ev[2] << 7) | ev[1]) - 8192
        ns.pitch_bends.append(PitchBend(
            time=time, bend=bend, program=channel_program[channel],
            is_drum=(channel == DRUM_CHANNEL),
            instrument=instrument_for(channel)))

  ns.total_time = max([n.end_time for n in ns.notes], default=0.0)
  return ns


def midi_file_to_note_sequence(path: str) -> NoteSequence:
  with open(path, 'rb') as f:
    ns = midi_to_note_sequence(f.read())
  ns.filename = path
  return ns


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------
def note_sequence_to_midi(ns: NoteSequence, qpm: float = DEFAULT_QPM) -> bytes:
  """Serialize a NoteSequence to format-1 SMF bytes at constant tempo."""
  ppq = ns.ticks_per_quarter or 220
  ticks_per_second = ppq * qpm / 60.0

  def to_tick(t: float) -> int:
    return max(0, int(round(t * ticks_per_second)))

  # Tempo track.
  uspq = int(round(6e7 / qpm))
  tempo_track = [(0, bytes([0xFF, 0x51, 0x03]) + uspq.to_bytes(3, 'big'))]

  # Group notes by instrument; assign channels (drums -> 9).
  by_instrument: Dict[int, List[Note]] = collections.defaultdict(list)
  for note in ns.notes:
    by_instrument[note.instrument].append(note)

  tracks = [tempo_track]
  next_channel = 0
  for instrument in sorted(by_instrument):
    notes = by_instrument[instrument]
    is_drum = any(n.is_drum for n in notes)
    if is_drum:
      channel = DRUM_CHANNEL
    else:
      if next_channel == DRUM_CHANNEL:
        next_channel += 1
      channel = next_channel % 16
      next_channel += 1
      if next_channel % 16 == DRUM_CHANNEL:
        next_channel += 1
    events = []
    program = notes[0].program if notes else 0
    events.append((0, 1, bytes([0xC0 | channel, program & 0x7F])))
    for note in notes:
      events.append((to_tick(note.start_time), 2,
                     bytes([0x90 | channel, note.pitch & 0x7F,
                            max(1, min(127, note.velocity))])))
      events.append((to_tick(note.end_time), 0,
                     bytes([0x80 | channel, note.pitch & 0x7F, 0])))
    for cc in ns.control_changes:
      if cc.instrument == instrument:
        events.append((to_tick(cc.time), 1,
                       bytes([0xB0 | channel, cc.control_number & 0x7F,
                              cc.control_value & 0x7F])))
    # Sort by (tick, priority): note-offs first at equal ticks so repeated
    # notes at the same tick don't cancel each other.
    events.sort(key=lambda e: (e[0], e[1]))
    tracks.append([(tick, ev) for tick, _, ev in events])

  chunks = [b'MThd' + (6).to_bytes(4, 'big') + (1).to_bytes(2, 'big')
            + len(tracks).to_bytes(2, 'big') + ppq.to_bytes(2, 'big')]
  for events in tracks:
    data = bytearray()
    last_tick = 0
    for tick, ev in events:
      data += _write_varint(tick - last_tick)
      data += ev
      last_tick = tick
    data += _write_varint(0) + bytes([0xFF, 0x2F, 0x00])  # end of track
    chunks.append(b'MTrk' + len(data).to_bytes(4, 'big') + bytes(data))
  return b''.join(chunks)


def note_sequence_to_midi_file(ns: NoteSequence, path: str,
                               qpm: float = DEFAULT_QPM) -> None:
  with open(path, 'wb') as f:
    f.write(note_sequence_to_midi(ns, qpm=qpm))
