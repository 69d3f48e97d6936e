"""NoteSequence protobuf wire-format codec (no protobuf dependency) (copy of mt3_tpu/core/noteseq_proto.py).

The reference corpora (mt3/datasets.py:55-323) store each
example's symbolic music as a serialized `note_seq.NoteSequence` proto in
the 'sequence' (or 'note_sequences') feature, parsed by
`note_seq.NoteSequence.FromString` (mt3/preprocessors.py:131).
This module reads and writes that wire format directly into our plain
NoteSequence dataclass, covering every field MT3's pipeline touches: notes
(pitch/velocity/times/instrument/program/is_drum), control changes (sustain
pedal), pitch bends, tempos, total_time, ticks_per_quarter, id/filename.

Field numbers follow the public `note_seq/protobuf/music.proto` schema
(Apache-2.0, magenta/note-seq).  Unknown fields are skipped on read and
never emitted on write, so round-tripping a reference record preserves the
MT3-relevant content.

The C++ fast path lives in native/tfrecord.cc (tfx_parse_notesequence);
this file is also the pure-Python fallback when the native library is not
built.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

from mt3_tpu_torch.core.note_sequence import (ControlChange, Note, NoteSequence,
                                        PitchBend, TempoChange)
from mt3_tpu_torch.data.tfrecord import (_field, _iter_fields, _length_delimited,
                                   _load_library, _varint)

# --- music.proto field numbers -------------------------------------------
# NoteSequence
F_ID = 1
F_FILENAME = 2
F_TICKS_PER_QUARTER = 4
F_TEMPOS = 7
F_NOTES = 8
F_TOTAL_TIME = 9
F_PITCH_BENDS = 10
F_CONTROL_CHANGES = 11
# NoteSequence.Note
N_PITCH = 1
N_VELOCITY = 2
N_START_TIME = 4
N_END_TIME = 5
N_INSTRUMENT = 8
N_PROGRAM = 9
N_IS_DRUM = 10
# NoteSequence.Tempo
T_TIME = 1
T_QPM = 2
# NoteSequence.ControlChange
CC_TIME = 1
CC_NUMBER = 2
CC_VALUE = 3
CC_INSTRUMENT = 4
CC_PROGRAM = 6
CC_IS_DRUM = 7
# NoteSequence.PitchBend
PB_TIME = 1
PB_BEND = 2
PB_INSTRUMENT = 3
PB_PROGRAM = 4
PB_IS_DRUM = 5


def _double(value) -> float:
  return struct.unpack('<d', value)[0]


def _zigzag_free_int(value: int) -> int:
  """music.proto uses plain int32 (no zigzag); sign-extend from uint64."""
  return value - (1 << 64) if value >= (1 << 63) else value


def _parse_note(data: bytes) -> Note:
  note = Note(pitch=0, velocity=0, start_time=0.0, end_time=0.0)
  for field, wire, value in _iter_fields(data):
    if field == N_PITCH:
      note.pitch = _zigzag_free_int(value)
    elif field == N_VELOCITY:
      note.velocity = _zigzag_free_int(value)
    elif field == N_START_TIME:
      note.start_time = _double(value)
    elif field == N_END_TIME:
      note.end_time = _double(value)
    elif field == N_INSTRUMENT:
      note.instrument = _zigzag_free_int(value)
    elif field == N_PROGRAM:
      note.program = _zigzag_free_int(value)
    elif field == N_IS_DRUM:
      note.is_drum = bool(value)
  return note


def _parse_tempo(data: bytes) -> TempoChange:
  tempo = TempoChange()
  for field, wire, value in _iter_fields(data):
    if field == T_TIME:
      tempo.time = _double(value)
    elif field == T_QPM:
      tempo.qpm = _double(value)
  return tempo


def _parse_control_change(data: bytes) -> ControlChange:
  cc = ControlChange(time=0.0, control_number=0, control_value=0)
  for field, wire, value in _iter_fields(data):
    if field == CC_TIME:
      cc.time = _double(value)
    elif field == CC_NUMBER:
      cc.control_number = _zigzag_free_int(value)
    elif field == CC_VALUE:
      cc.control_value = _zigzag_free_int(value)
    elif field == CC_INSTRUMENT:
      cc.instrument = _zigzag_free_int(value)
    elif field == CC_PROGRAM:
      cc.program = _zigzag_free_int(value)
    elif field == CC_IS_DRUM:
      cc.is_drum = bool(value)
  return cc


def _parse_pitch_bend(data: bytes) -> PitchBend:
  pb = PitchBend(time=0.0, bend=0)
  for field, wire, value in _iter_fields(data):
    if field == PB_TIME:
      pb.time = _double(value)
    elif field == PB_BEND:
      pb.bend = _zigzag_free_int(value)
    elif field == PB_INSTRUMENT:
      pb.instrument = _zigzag_free_int(value)
    elif field == PB_PROGRAM:
      pb.program = _zigzag_free_int(value)
    elif field == PB_IS_DRUM:
      pb.is_drum = bool(value)
  return pb


def notesequence_from_bytes(data: bytes) -> NoteSequence:
  """Parse a serialized NoteSequence proto (native path if built)."""
  lib = _load_library()
  if lib is not None and hasattr(lib, 'tfx_parse_notesequence'):
    return _notesequence_from_bytes_native(lib, data)
  return _notesequence_from_bytes_py(data)


def _notesequence_from_bytes_py(data: bytes) -> NoteSequence:
  ns = NoteSequence()
  for field, wire, value in _iter_fields(data):
    if field == F_NOTES:
      ns.notes.append(_parse_note(value))
    elif field == F_TOTAL_TIME:
      ns.total_time = _double(value)
    elif field == F_CONTROL_CHANGES:
      ns.control_changes.append(_parse_control_change(value))
    elif field == F_PITCH_BENDS:
      ns.pitch_bends.append(_parse_pitch_bend(value))
    elif field == F_TEMPOS:
      ns.tempos.append(_parse_tempo(value))
    elif field == F_TICKS_PER_QUARTER:
      ns.ticks_per_quarter = _zigzag_free_int(value)
    elif field == F_ID:
      ns.id = value.decode('utf-8', errors='replace')
    elif field == F_FILENAME:
      ns.filename = value.decode('utf-8', errors='replace')
  return ns


# --- native (C++) parse ----------------------------------------------------
class _NSHeader(ctypes.Structure):
  _fields_ = [
      ('num_notes', ctypes.c_long),
      ('num_control_changes', ctypes.c_long),
      ('num_pitch_bends', ctypes.c_long),
      ('num_tempos', ctypes.c_long),
      ('total_time', ctypes.c_double),
      ('ticks_per_quarter', ctypes.c_int),
  ]


_NATIVE_CONFIGURED = False


def _configure_native(lib):
  global _NATIVE_CONFIGURED
  if _NATIVE_CONFIGURED:
    return
  lib.tfx_parse_notesequence.restype = ctypes.c_void_p
  lib.tfx_parse_notesequence.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
  lib.tfx_ns_header.argtypes = [ctypes.c_void_p, ctypes.POINTER(_NSHeader)]
  # Notes: 7 columns [pitch, velocity, start, end, instrument, program,
  # is_drum] as float64.
  lib.tfx_ns_notes.argtypes = [ctypes.c_void_p,
                               np.ctypeslib.ndpointer(np.float64)]
  lib.tfx_ns_control_changes.argtypes = [
      ctypes.c_void_p, np.ctypeslib.ndpointer(np.float64)]
  lib.tfx_ns_pitch_bends.argtypes = [
      ctypes.c_void_p, np.ctypeslib.ndpointer(np.float64)]
  lib.tfx_ns_tempos.argtypes = [
      ctypes.c_void_p, np.ctypeslib.ndpointer(np.float64)]
  lib.tfx_ns_id.restype = ctypes.c_char_p
  lib.tfx_ns_id.argtypes = [ctypes.c_void_p]
  lib.tfx_ns_filename.restype = ctypes.c_char_p
  lib.tfx_ns_filename.argtypes = [ctypes.c_void_p]
  lib.tfx_free_notesequence.argtypes = [ctypes.c_void_p]
  _NATIVE_CONFIGURED = True


def _notesequence_from_bytes_native(lib, data: bytes) -> NoteSequence:
  _configure_native(lib)
  handle = lib.tfx_parse_notesequence(data, len(data))
  if not handle:
    raise ValueError('malformed NoteSequence proto')
  try:
    header = _NSHeader()
    lib.tfx_ns_header(handle, ctypes.byref(header))
    ns = NoteSequence(total_time=header.total_time,
                      ticks_per_quarter=header.ticks_per_quarter or 220)
    ns.id = (lib.tfx_ns_id(handle) or b'').decode('utf-8', errors='replace')
    ns.filename = (lib.tfx_ns_filename(handle) or b'').decode(
        'utf-8', errors='replace')
    if header.num_notes:
      cols = np.empty((header.num_notes, 7), np.float64)
      lib.tfx_ns_notes(handle, cols)
      ns.notes = [
          Note(pitch=int(r[0]), velocity=int(r[1]), start_time=r[2],
               end_time=r[3], instrument=int(r[4]), program=int(r[5]),
               is_drum=bool(r[6])) for r in cols]
    if header.num_control_changes:
      cols = np.empty((header.num_control_changes, 6), np.float64)
      lib.tfx_ns_control_changes(handle, cols)
      ns.control_changes = [
          ControlChange(time=r[0], control_number=int(r[1]),
                        control_value=int(r[2]), instrument=int(r[3]),
                        program=int(r[4]), is_drum=bool(r[5]))
          for r in cols]
    if header.num_pitch_bends:
      cols = np.empty((header.num_pitch_bends, 5), np.float64)
      lib.tfx_ns_pitch_bends(handle, cols)
      ns.pitch_bends = [
          PitchBend(time=r[0], bend=int(r[1]), instrument=int(r[2]),
                    program=int(r[3]), is_drum=bool(r[4])) for r in cols]
    if header.num_tempos:
      cols = np.empty((header.num_tempos, 2), np.float64)
      lib.tfx_ns_tempos(handle, cols)
      ns.tempos = [TempoChange(time=r[0], qpm=r[1]) for r in cols]
    return ns
  finally:
    lib.tfx_free_notesequence(handle)


# --- serialization ---------------------------------------------------------
def _emit_varint_field(number: int, value: int) -> bytes:
  if not value:
    return b''
  return _field(number, 0, _varint(value & 0xFFFFFFFFFFFFFFFF))


def _emit_double_field(number: int, value: float) -> bytes:
  if value == 0.0:
    return b''
  return _field(number, 1, struct.pack('<d', value))


def _note_bytes(note: Note) -> bytes:
  return (_emit_varint_field(N_PITCH, int(note.pitch))
          + _emit_varint_field(N_VELOCITY, int(note.velocity))
          + _emit_double_field(N_START_TIME, float(note.start_time))
          + _emit_double_field(N_END_TIME, float(note.end_time))
          + _emit_varint_field(N_INSTRUMENT, int(note.instrument))
          + _emit_varint_field(N_PROGRAM, int(note.program))
          + _emit_varint_field(N_IS_DRUM, int(bool(note.is_drum))))


def _cc_bytes(cc: ControlChange) -> bytes:
  return (_emit_double_field(CC_TIME, float(cc.time))
          + _emit_varint_field(CC_NUMBER, int(cc.control_number))
          + _emit_varint_field(CC_VALUE, int(cc.control_value))
          + _emit_varint_field(CC_INSTRUMENT, int(cc.instrument))
          + _emit_varint_field(CC_PROGRAM, int(cc.program))
          + _emit_varint_field(CC_IS_DRUM, int(bool(cc.is_drum))))


def _pb_bytes(pb: PitchBend) -> bytes:
  return (_emit_double_field(PB_TIME, float(pb.time))
          + _emit_varint_field(PB_BEND, int(pb.bend))
          + _emit_varint_field(PB_INSTRUMENT, int(pb.instrument))
          + _emit_varint_field(PB_PROGRAM, int(pb.program))
          + _emit_varint_field(PB_IS_DRUM, int(bool(pb.is_drum))))


def _tempo_bytes(tempo: TempoChange) -> bytes:
  return (_emit_double_field(T_TIME, float(tempo.time))
          + _emit_double_field(T_QPM, float(tempo.qpm)))


def notesequence_to_bytes(ns: NoteSequence) -> bytes:
  """Serialize to NoteSequence proto wire format (readable by note_seq)."""
  out = bytearray()
  if ns.id:
    out += _length_delimited(F_ID, ns.id.encode())
  if ns.filename:
    out += _length_delimited(F_FILENAME, ns.filename.encode())
  out += _emit_varint_field(F_TICKS_PER_QUARTER, int(ns.ticks_per_quarter))
  for tempo in ns.tempos:
    out += _length_delimited(F_TEMPOS, _tempo_bytes(tempo))
  for note in ns.notes:
    out += _length_delimited(F_NOTES, _note_bytes(note))
  out += _emit_double_field(F_TOTAL_TIME, float(ns.total_time))
  for pb in ns.pitch_bends:
    out += _length_delimited(F_PITCH_BENDS, _pb_bytes(pb))
  for cc in ns.control_changes:
    out += _length_delimited(F_CONTROL_CHANGES, _cc_bytes(cc))
  return bytes(out)
