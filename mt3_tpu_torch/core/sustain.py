"""Sustain-pedal application (copy of mt3_tpu/core/sustain.py).

Equivalent of note_seq.apply_sustain_control_changes, which the reference
applies before tokenizing training targets
(mt3/preprocessors.py:154).

Semantics: while the sustain pedal (CC 64, value >= 64) is down on an
instrument, note releases are deferred until the pedal is lifted.  If a
pitch is re-struck while its sustained predecessor is still sounding, the
predecessor is truncated at the new onset.  Notes still sustained at the end
of the sequence are extended to the sequence end.
"""

from __future__ import annotations

from mt3_tpu_torch.core.note_sequence import NoteSequence

SUSTAIN_CC = 64

# Event-type sort priority at equal times: pedal events are processed first
# so that a note ending exactly when the pedal lifts is not extended, and
# note-ons before note-offs so re-strikes see the sustained note as active.
_SUSTAIN_ON = 0
_SUSTAIN_OFF = 1
_NOTE_ON = 2
_NOTE_OFF = 3


def apply_sustain_control_changes(
    ns: NoteSequence, sustain_control_number: int = SUSTAIN_CC
) -> NoteSequence:
  """Return a copy of `ns` with sustain pedal applied to note durations."""
  seq = ns.copy()

  events = []
  for cc in seq.control_changes:
    if cc.control_number != sustain_control_number:
      continue
    kind = _SUSTAIN_ON if cc.control_value >= 64 else _SUSTAIN_OFF
    events.append((cc.time, kind, cc))
  for note in seq.notes:
    events.append((note.start_time, _NOTE_ON, note))
    events.append((note.end_time, _NOTE_OFF, note))
  events.sort(key=lambda e: (e[0], e[1]))

  # Per-instrument pedal state and per-instrument list of notes whose
  # release has been deferred (or that are still sounding under the pedal).
  sustain_down = {}
  active_notes = {}
  deleted_notes = []

  time = 0.0
  for time, kind, obj in events:
    instrument = obj.instrument
    if kind == _SUSTAIN_ON:
      sustain_down[instrument] = True
    elif kind == _SUSTAIN_OFF:
      sustain_down[instrument] = False
      still_active = []
      for note in active_notes.get(instrument, []):
        if note.end_time < time:
          # Release was deferred; the pedal lift ends the note now.
          note.end_time = time
          seq.total_time = max(seq.total_time, time)
        else:
          # Note is still held by the key itself.
          still_active.append(note)
      active_notes[instrument] = still_active
    elif kind == _NOTE_ON:
      if sustain_down.get(instrument, False):
        # If this pitch is already sounding (sustained), truncate the old
        # note at the new onset to avoid overlap.
        actives = active_notes.get(instrument, [])
        for prev in list(actives):
          if prev.pitch == obj.pitch:
            actives.remove(prev)
            if prev.start_time >= time:
              # Truncation would produce a zero/negative-length note.
              deleted_notes.append(prev)
            else:
              prev.end_time = time
      active_notes.setdefault(instrument, []).append(obj)
    else:  # _NOTE_OFF
      if sustain_down.get(instrument, False):
        pass  # defer the release until the pedal lifts
      else:
        actives = active_notes.get(instrument, [])
        if obj in actives:
          actives.remove(obj)

  # End any notes still sustained at the end of the sequence.
  end_time = max(time, seq.total_time)
  for notes in active_notes.values():
    for note in notes:
      if note.end_time < end_time:
        note.end_time = end_time
  if seq.notes:
    seq.total_time = max([seq.total_time] + [n.end_time for n in seq.notes])

  if deleted_notes:
    seq.notes = [n for n in seq.notes
                 if not any(n is d for d in deleted_notes)]

  # Sustain information has been folded into durations.
  seq.control_changes = [cc for cc in seq.control_changes
                         if cc.control_number != sustain_control_number]
  return seq
