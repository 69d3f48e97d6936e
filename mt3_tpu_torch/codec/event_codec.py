"""Typed event <-> integer index codec.

Capability-parity rebuild of the reference event codec
(mt3/event_codec.py:34-112): maps typed events
(shift / pitch / velocity / tie / program / drum) onto contiguous integer
ranges, with 'shift' always the first block starting at index 0.

Unlike the reference's linear scans, ranges are resolved via precomputed
offset tables for O(1) encode and O(log k) decode.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class EventRange:
  type: str
  min_value: int
  max_value: int


@dataclasses.dataclass(frozen=True)
class Event:
  type: str
  value: int


class Codec:
  """Encode and decode typed events to/from a contiguous index space."""

  def __init__(self, max_shift_steps: int, steps_per_second: float,
               event_ranges: Sequence[EventRange]):
    self.steps_per_second = steps_per_second
    self._shift_range = EventRange('shift', 0, max_shift_steps)
    self._event_ranges: List[EventRange] = (
        [self._shift_range] + list(event_ranges))
    if len(self._event_ranges) != len(
        set(er.type for er in self._event_ranges)):
      raise ValueError('duplicate event type in codec ranges')

    # Precompute offsets for O(1) encode / O(log k) decode.
    self._offsets = {}
    self._range_by_type = {}
    self._starts: List[int] = []
    offset = 0
    for er in self._event_ranges:
      self._offsets[er.type] = offset
      self._range_by_type[er.type] = er
      self._starts.append(offset)
      offset += er.max_value - er.min_value + 1
    self._num_classes = offset

  @property
  def num_classes(self) -> int:
    return self._num_classes

  @property
  def max_shift_steps(self) -> int:
    return self._shift_range.max_value

  def is_shift_event_index(self, index: int) -> bool:
    return 0 <= index <= self._shift_range.max_value

  def encode_event(self, event: Event) -> int:
    if event.type not in self._offsets:
      raise ValueError(f'Unknown event type: {event.type}')
    er_offset = self._offsets[event.type]
    er = self._range_by_type[event.type]
    if not er.min_value <= event.value <= er.max_value:
      raise ValueError(
          f'Event value {event.value} is not within valid range '
          f'[{er.min_value}, {er.max_value}] for type {event.type}')
    return er_offset + event.value - er.min_value

  def event_type_range(self, event_type: str) -> Tuple[int, int]:
    """Return [min_id, max_id] for an event type."""
    if event_type not in self._offsets:
      raise ValueError(f'Unknown event type: {event_type}')
    offset = self._offsets[event_type]
    er = self._range_by_type[event_type]
    return offset, offset + (er.max_value - er.min_value)

  def decode_event_index(self, index: int) -> Event:
    if not 0 <= index < self._num_classes:
      raise ValueError(f'Unknown event index: {index}')
    i = bisect.bisect_right(self._starts, index) - 1
    er = self._event_ranges[i]
    return Event(type=er.type, value=er.min_value + index - self._starts[i])

  @property
  def event_types(self) -> List[str]:
    return [er.type for er in self._event_ranges]
