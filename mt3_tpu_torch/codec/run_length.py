"""Run-length encoding of event streams.

Capability-parity rebuild of mt3/run_length_encoding.py with
the TF/autograph dataset plumbing replaced by vectorized NumPy operating on
plain arrays.  Semantics contracts (verified by tests):

  * encode_and_index_events: expands inter-event gaps into 1-step shifts and
    indexes every audio frame to (event_start, event_end, state_event)
    positions (reference :63-167).
  * run_length_encode_shifts: collapses runs of 1-step shifts into *absolute*
    step values within the segment, chunked at max_shift_steps, trimming
    trailing shifts (reference :242-295).
  * remove_redundant_state_changes: drops state-change tokens (velocity /
    program) equal to the current state (reference :194-239).
  * merge_run_length_encoded_targets: k-way time-ordered merge of multiple
    RLE streams, for audio mixing (reference :298-368).
  * decode_events: token -> event replay with start_time offset and max_time
    dropping (reference :371-423).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np

from mt3_tpu_torch.codec import event_codec

Event = event_codec.Event

EventData = Any
EncodingState = Any
DecodingState = Any
DecodeResult = Any


@dataclasses.dataclass
class EventEncodingSpec:
  """Spec bundling the callbacks that define an event encoding."""
  init_encoding_state_fn: Callable[[], EncodingState]
  encode_event_fn: Callable[
      [EncodingState, EventData, event_codec.Codec], Sequence[Event]]
  encoding_state_to_events_fn: Optional[
      Callable[[EncodingState], Sequence[Event]]]
  init_decoding_state_fn: Callable[[], DecodingState]
  begin_decoding_segment_fn: Callable[[DecodingState], None]
  decode_event_fn: Callable[
      [DecodingState, float, Event, event_codec.Codec], None]
  flush_decoding_state_fn: Callable[[DecodingState], DecodeResult]


def encode_and_index_events(
    state: EncodingState,
    event_times: Sequence[float],
    event_values: Sequence[EventData],
    encode_event_fn: Callable[
        [EncodingState, EventData, event_codec.Codec], Sequence[Event]],
    codec: event_codec.Codec,
    frame_times: Sequence[float],
    encoding_state_to_events_fn: Optional[
        Callable[[EncodingState], Sequence[Event]]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
  """Encode timed events as tokens plus per-frame index maps.

  Time shifts are emitted as repeated single-step shifts for later
  run-length encoding.  Returns (events, event_start_indices,
  event_end_indices, state_events, state_event_indices); see the reference
  docstring (run_length_encoding.py:74-110) for the exact contract.
  """
  sps = codec.steps_per_second
  order = np.argsort(event_times, kind='stable')
  shift_token = codec.encode_event(Event('shift', 1))
  frame_times = np.asarray(frame_times, dtype=np.float64)

  # --- Pass 1: encode events in time order (state mutates sequentially),
  # recording for each event its quantized step, its tokens, and how many
  # state tokens existed before it.
  per_event = []  # (step, [tokens])
  state_events = []
  state_count_before_step = {}  # step -> len(state_events) before first event at step
  for i in order:
    step = round(event_times[i] * sps)
    state_count_before_step.setdefault(step, len(state_events))
    if encoding_state_to_events_fn:
      # The state snapshot precedes the event it accompanies.
      state_events.extend(codec.encode_event(e)
                          for e in encoding_state_to_events_fn(state))
    toks = [codec.encode_event(e)
            for e in encode_event_fn(state, event_values[i], codec)]
    per_event.append((step, toks))

  # --- Pass 2: assemble the token stream.  Layout is
  #   tokens@step0, shift, tokens@step1, shift, tokens@step2, ...
  # i.e. one single-step shift crosses into each step s >= 1, followed by
  # the tokens of all events quantized to step s.  The stream must extend
  # far enough that every audio frame is preceded by a shift: the last
  # shift crosses into step S = max(last event step, first step strictly
  # after the final frame time).
  last_event_step = per_event[-1][0] if per_event else 0
  first_step_past_audio = int(frame_times[-1] * sps)
  while first_step_past_audio / sps <= frame_times[-1]:
    first_step_past_audio += 1
  total_steps = max(last_event_step, first_step_past_audio)

  tokens_at_step = {}
  for step, toks in per_event:
    tokens_at_step.setdefault(step, []).extend(toks)

  stream = []
  # tokens_through_shift[s] = stream length right after the shift into step
  # s (events at step s not yet appended); used for frame indexing below.
  tokens_through_shift = np.zeros(total_steps + 1, dtype=np.int64)
  stream.extend(tokens_at_step.get(0, ()))
  for s in range(1, total_steps + 1):
    stream.append(shift_token)
    tokens_through_shift[s] = len(stream)
    stream.extend(tokens_at_step.get(s, ()))

  # --- Pass 3: index every audio frame.  A frame at time t belongs to the
  # first step s with t < s / sps; its start index is the stream position
  # just after the shift into step s - 1 (so the slice for a chunk starting
  # at that frame opens with the events of the frame's own step).
  step_grid = np.arange(total_steps + 2) / sps
  frame_step = np.searchsorted(step_grid, frame_times, side='right')
  frame_step = np.clip(frame_step, 1, total_steps)  # guard fp edge cases
  event_start_indices = tokens_through_shift[frame_step - 1]

  # State-token index per frame: count of state tokens emitted before the
  # first event at step >= frame_step - 1.  Frames past the last event keep
  # the count as of the last event's step (the tail of the stream is pure
  # shifts and emits no state).
  if state_events:
    steps_sorted = np.array(sorted(state_count_before_step), dtype=np.int64)
    counts_sorted = np.array(
        [state_count_before_step[s] for s in steps_sorted], dtype=np.int64)
    query = np.minimum(frame_step - 1, steps_sorted[-1])
    pos = np.searchsorted(steps_sorted, query, side='left')
    state_event_indices = counts_sorted[pos]
  else:
    state_event_indices = np.zeros(len(frame_times), dtype=np.int64)

  event_end_indices = np.concatenate(
      [event_start_indices[1:], [len(stream)]])

  return (np.array(stream, dtype=np.int32),
          event_start_indices.astype(np.int32),
          event_end_indices.astype(np.int32),
          np.array(state_events, dtype=np.int32),
          state_event_indices.astype(np.int32))


def extract_target_sequence_with_indices(
    features: dict, state_events_end_token: Optional[int] = None) -> dict:
  """Slice `targets` to the audio-token segment; optionally prepend ties.

  Reference: run_length_encoding.py:170-191.  `features` must carry
  'input_event_start_indices' / 'input_event_end_indices' aligned to the
  (already-cropped) 'inputs' frame axis.
  """
  target_start_idx = int(features['input_event_start_indices'][0])
  target_end_idx = int(features['input_event_end_indices'][-1])

  features['targets'] = features['targets'][target_start_idx:target_end_idx]

  if state_events_end_token is not None:
    state_event_start_idx = int(features['input_state_event_indices'][0])
    state_event_end_idx = state_event_start_idx + 1
    while (features['state_events'][state_event_end_idx - 1]
           != state_events_end_token):
      state_event_end_idx += 1
    features['targets'] = np.concatenate([
        features['state_events'][state_event_start_idx:state_event_end_idx],
        features['targets']], axis=0)
  return features


def remove_redundant_state_changes(
    tokens: np.ndarray,
    codec: event_codec.Codec,
    state_change_event_types: Sequence[str] = (),
) -> np.ndarray:
  """Remove redundant state-change tokens (e.g. duplicate velocities).

  Vectorized: for each state-change type, a token is redundant iff it equals
  the previous token of the same type.  Reference semantics:
  run_length_encoding.py:194-239.
  """
  tokens = np.asarray(tokens, dtype=np.int32)
  keep = np.ones(len(tokens), dtype=bool)
  for event_type in state_change_event_types:
    min_index, max_index = codec.event_type_range(event_type)
    in_range = (tokens >= min_index) & (tokens <= max_index)
    (positions,) = np.nonzero(in_range)
    if len(positions) > 1:
      redundant = tokens[positions[1:]] == tokens[positions[:-1]]
      keep[positions[1:][redundant]] = False
  return tokens[keep]


def run_length_encode_shifts(
    tokens: np.ndarray, codec: event_codec.Codec) -> np.ndarray:
  """Collapse runs of shift tokens into absolute step values.

  Each shift token in the input counts as one step (inputs are single-step
  shifts from encode_and_index_events).  Before each non-shift event that
  follows at least one shift, the *total* step count so far is emitted,
  chunked at max_shift_steps.  Trailing shifts are trimmed.  Reference:
  run_length_encoding.py:242-295; vectorized here.
  """
  tokens = np.asarray(tokens, dtype=np.int32)
  if tokens.size == 0:
    return tokens
  is_shift = (tokens >= 0) & (tokens <= codec.max_shift_steps)

  total_steps = np.cumsum(is_shift)
  event_idx = np.nonzero(~is_shift)[0]
  if event_idx.size == 0:
    return np.array([], dtype=np.int32)
  events = tokens[event_idx]
  # Step total at each event; totals are nondecreasing, so "changed
  # since last emission" reduces to a positive first difference, and a
  # value can never recur after it stops being emitted.
  ev_steps = total_steps[event_idx]
  emit = (ev_steps > 0) & (np.diff(ev_steps, prepend=0) > 0)

  if not emit.any():
    return events.astype(np.int32)
  emit_steps = ev_steps[emit]
  if int(emit_steps[-1]) <= codec.max_shift_steps:
    # Fast path (typical: segment spans < max_shift_steps): exactly one
    # shift token per emission, placed before its event.
    return np.insert(events, np.nonzero(emit)[0],
                     emit_steps).astype(np.int32)

  # Chunked path: a total past max_shift_steps is emitted as
  # [max, max, ..., remainder] before the event.
  output = []
  for i in range(events.size):
    if emit[i]:
      remaining = int(ev_steps[i])
      while remaining > 0:
        out = min(codec.max_shift_steps, remaining)
        output.append(out)
        remaining -= out
    output.append(int(events[i]))
  return np.array(output, dtype=np.int32)


def merge_run_length_encoded_targets(
    targets: np.ndarray, codec: event_codec.Codec) -> np.ndarray:
  """Merge multiple RLE target tracks into one time-ordered stream.

  `targets` is [num_tracks, padded_length] with zero padding (zero is never
  a real token here).  Reference: run_length_encoding.py:298-368.
  """
  targets = np.asarray(targets, dtype=np.int32)
  num_tracks, targets_length = targets.shape

  # Precompute, per track: shift-ness of every token and the next scan
  # boundary (shift token or zero padding) at or after each position.
  # The merge loop then does O(1) work per token instead of a method
  # call per scanned position (the measured mixing hot spot).
  is_shift = (targets >= 0) & (targets <= codec.max_shift_steps)
  stop = is_shift | (targets == 0)
  positions = np.arange(targets_length, dtype=np.int64)
  boundary = np.where(stop, positions[None, :], targets_length)
  next_stop = np.minimum.accumulate(boundary[:, ::-1], axis=1)[:, ::-1]

  heads = [list(map(int, targets[i])) for i in range(num_tracks)]
  shift_rows = [row.tolist() for row in is_shift]
  next_rows = [row.tolist() for row in next_stop]

  current_step = 0
  current_offsets = [0] * num_tracks
  slices = []

  while True:
    # Find the track with the earliest next step.
    next_step = codec.max_shift_steps + 1
    next_track = -1
    for i in range(num_tracks):
      off = current_offsets[i]
      if off == targets_length or heads[i][off] == 0:
        continue  # track exhausted (zero is always padding)
      if not shift_rows[i][off]:
        # Non-shift head means we haven't reached the first shift: step 0.
        next_step = 0
        next_track = i
      elif heads[i][off] < next_step:
        next_step = heads[i][off]
        next_track = i

    if next_track == -1:
      break

    if next_step == current_step and next_step > 0:
      # Same step as previous shift; skip the duplicate shift token.
      start_offset = current_offsets[next_track] + 1
    else:
      start_offset = current_offsets[next_track]

    # Merge events up to but not including the next shift / padding.
    if start_offset + 1 < targets_length:
      end_offset = next_rows[next_track][start_offset + 1]
    else:
      # A duplicate-shift skip at the last column can push start_offset
      # to targets_length; clamp so the track reads as exhausted instead
      # of indexing past the row.
      end_offset = min(start_offset + 1, targets_length)
    slices.append(targets[next_track, start_offset:end_offset])

    current_step = next_step
    current_offsets[next_track] = end_offset

  if not slices:
    return np.array([], dtype=np.int32)
  return np.concatenate(slices).astype(np.int32)


def decode_events(
    state: DecodingState,
    tokens: np.ndarray,
    start_time: float,
    max_time: Optional[float],
    codec: event_codec.Codec,
    decode_event_fn: Callable[
        [DecodingState, float, Event, event_codec.Codec], None],
) -> Tuple[int, int]:
  """Replay a token stream through a decoding state machine.

  Returns (invalid_events, dropped_events).  Reference:
  run_length_encoding.py:371-423.
  """
  invalid_events = 0
  dropped_events = 0
  cur_steps = 0
  cur_time = start_time
  for token_idx, token in enumerate(tokens):
    try:
      event = codec.decode_event_index(int(token))
    except ValueError:
      invalid_events += 1
      continue
    if event.type == 'shift':
      cur_steps += event.value
      cur_time = start_time + cur_steps / codec.steps_per_second
      if max_time and cur_time > max_time:
        dropped_events = len(tokens) - token_idx
        break
    else:
      cur_steps = 0
      try:
        decode_event_fn(state, cur_time, event, codec)
      except ValueError:
        invalid_events += 1
        logging.debug(
            'Invalid event %s at time %f; invalid count now %d',
            event, cur_time, invalid_events)
        continue
  return invalid_events, dropped_events
