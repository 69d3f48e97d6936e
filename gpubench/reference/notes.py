"""Tokens to notes, from MT3's event vocabulary, in plain Python.

Token ids: 0 PAD, 1 EOS, 2 UNK, then the codec's classes (shift steps
0..max, pitch 0-127, velocity bins 0..n, the tie marker, program 0-127,
drum 0-127), then unused ids.  A segment's tokens end at the first EOS.
Shifts give the time since the segment's start, in steps of 1 /
steps_per_second (consecutive shifts add up; any other event restarts
the count).  A segment's events stop at the first shift past the next
segment's start.  Events that do not fit the decoding state (a note-off
for a silent pitch, a tie outside a tie section, an event before the
clock, an unknown id) are counted as invalid and skipped.  Segments
start with a tie section when the vocabulary uses ties.  Every note is
at least 10 ms long; drums last 10 ms; at the end every sounding note
stops at the latest of the clock and its onset + 10 ms.  Instruments are
numbered by first appearance of each program, 9 skipped; drums take 9.

Returns note tuples (pitch, velocity, start, end, program, is_drum,
instrument) in the order they are completed, and the invalid and dropped
event counts.
"""

from __future__ import annotations

MIN_DURATION = 0.01
DRUM_DURATION = 0.01
DEFAULT_VELOCITY = 100
SPECIAL = 3
EOS = 1


class _Vocab:

  def __init__(self, vocab):
    self.steps = vocab['steps_per_second']
    self.bins = vocab['num_velocity_bins']
    self.ties = vocab['use_ties']
    sizes = [('shift', self.steps * vocab['max_shift_seconds'] + 1),
             ('pitch', 128), ('velocity', self.bins + 1), ('tie', 1),
             ('program', 128), ('drum', 128)]
    self.ranges, start = [], 0
    for name, size in sizes:
      self.ranges.append((name, start, size))
      start += size
    self.classes = start

  def event(self, token):
    """(type, value) of a model id, or None for an id outside the codec."""
    index = token - SPECIAL
    if not 0 <= index < self.classes:
      return None
    for name, start, size in self.ranges:
      if index < start + size:
        return name, index - start


class _State:

  def __init__(self):
    self.time = 0.0
    self.velocity = DEFAULT_VELOCITY
    self.program = 0
    self.active = {}
    self.tied = set()
    self.tie_section = False
    self.notes = []

  def add(self, start, end, pitch, velocity, program=0, drum=False):
    self.notes.append([pitch, velocity, start, max(end, start + MIN_DURATION),
                       program, drum])

  def finish(self, key, end):
    start, velocity = self.active.pop(key)
    self.add(start, end, key[0], velocity, key[1])


def _apply(state, vocab, time, kind, value):
  """One event; False where it does not fit the state."""
  if time < state.time:
    return False
  state.time = time
  if kind == 'pitch':
    key = (value, state.program)
    if state.tie_section:
      if key not in state.active or key in state.tied:
        return False
      state.tied.add(key)
      return True
    if state.velocity == 0 and key not in state.active:
      return False
    if key in state.active:
      state.finish(key, time)
    if state.velocity > 0:
      state.active[key] = (time, state.velocity)
  elif kind == 'drum':
    if state.velocity == 0:
      return False
    state.add(time, time + DRUM_DURATION, value, state.velocity, drum=True)
  elif kind == 'velocity':
    state.velocity = 0 if value == 0 else int(127 * value / vocab.bins)
  elif kind == 'program':
    state.program = value
  elif kind == 'tie':
    if not state.tie_section:
      return False
    for key in [k for k in state.active if k not in state.tied]:
      state.finish(key, time)
    state.tie_section = False
  return True


def decode(segments, vocab_config):
  """segments: [(start seconds, model ids)] -> (notes, invalid, dropped)."""
  vocab = _Vocab(vocab_config)
  step = 1 / vocab.steps
  segments = sorted(((start - start % step, list(tokens))
                     for start, tokens in segments), key=lambda s: s[0])
  state = _State()
  invalid = dropped = 0
  for i, (start, tokens) in enumerate(segments):
    if EOS in tokens:
      tokens = tokens[:tokens.index(EOS)]
    if vocab.ties:
      state.tied = set()
      state.tie_section = True
    max_time = segments[i + 1][0] if i + 1 < len(segments) else None
    steps, time = 0, start
    for j, token in enumerate(tokens):
      event = vocab.event(token)
      if event is None:
        invalid += 1
        continue
      kind, value = event
      if kind == 'shift':
        steps += value
        time = start + steps / vocab.steps
        if max_time and time > max_time:
          dropped += len(tokens) - j
          break
        continue
      steps = 0
      if not _apply(state, vocab, time, kind, value):
        invalid += 1
  for onset, _ in state.active.values():
    state.time = max(state.time, onset + MIN_DURATION)
  for key in list(state.active):
    state.finish(key, state.time)
  programs = {}
  for note in state.notes:
    program, drum = note[4], note[5]
    if drum:
      note.append(9)
    elif program not in programs:
      programs[program] = len(programs) if len(programs) < 9 else len(programs) + 1
      note.append(programs[program])
    else:
      note.append(programs[program])
  return [tuple(n) for n in state.notes], invalid, dropped
