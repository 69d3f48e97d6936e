"""Token vocabulary: codec indices <-> model token ids.

Capability-parity rebuild of mt3/vocabularies.py: the model
id space prepends 3 special tokens (PAD=0, EOS=1, UNK=2) to the codec's
event-index space, and appends `extra_ids` sentinel ids (T5 convention,
default 100).  Decoding maps EOS to DECODED_EOS_ID (-1) and anything
out-of-range to DECODED_INVALID_ID (-2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from mt3_tpu_torch.codec import event_codec
from mt3_tpu_torch.core.config import (MAX_MIDI_PITCH, MAX_MIDI_PROGRAM,
                                 MAX_MIDI_VELOCITY, MIN_MIDI_PITCH,
                                 MIN_MIDI_PROGRAM, VocabularyConfig)

DECODED_EOS_ID = -1
DECODED_INVALID_ID = -2

# t5.data.DEFAULT_EXTRA_IDS in the reference dependency chain.
DEFAULT_EXTRA_IDS = 100

PAD_ID = 0
EOS_ID = 1
UNK_ID = 2
NUM_SPECIAL_TOKENS = 3


def num_velocity_bins_from_codec(codec: event_codec.Codec) -> int:
  lo, hi = codec.event_type_range('velocity')
  return hi - lo


def velocity_to_bin(velocity: int, num_velocity_bins: int) -> int:
  if velocity == 0:
    return 0
  return math.ceil(num_velocity_bins * velocity / MAX_MIDI_VELOCITY)


def bin_to_velocity(velocity_bin: int, num_velocity_bins: int) -> int:
  if velocity_bin == 0:
    return 0
  return int(MAX_MIDI_VELOCITY * velocity_bin / num_velocity_bins)


def drop_programs(tokens: np.ndarray,
                  codec: event_codec.Codec) -> np.ndarray:
  """Drop program-change events from a codec-index token sequence."""
  tokens = np.asarray(tokens)
  min_program_id, max_program_id = codec.event_type_range('program')
  return tokens[(tokens < min_program_id) | (tokens > max_program_id)]


def programs_to_midi_classes(tokens: np.ndarray,
                             codec: event_codec.Codec) -> np.ndarray:
  """Map each program event to the first program in its MIDI class."""
  tokens = np.asarray(tokens)
  min_program_id, max_program_id = codec.event_type_range('program')
  is_program = (tokens >= min_program_id) & (tokens <= max_program_id)
  return np.where(
      is_program,
      min_program_id + 8 * ((tokens - min_program_id) // 8),
      tokens)


@dataclasses.dataclass
class ProgramGranularity:
  # Both functions must be idempotent.
  tokens_map_fn: Callable[[np.ndarray, event_codec.Codec], np.ndarray]
  program_map_fn: Callable[[int], int]


PROGRAM_GRANULARITIES = {
    # Drop program tokens; all NoteSequence programs -> 0.
    'flat': ProgramGranularity(
        tokens_map_fn=drop_programs,
        program_map_fn=lambda program: 0),
    # Map each program to the first program in its MIDI class.
    'midi_class': ProgramGranularity(
        tokens_map_fn=programs_to_midi_classes,
        program_map_fn=lambda program: 8 * (program // 8)),
    # Leave programs as-is.
    'full': ProgramGranularity(
        tokens_map_fn=lambda tokens, codec: tokens,
        program_map_fn=lambda program: program),
}


def build_codec(vocab_config: VocabularyConfig) -> event_codec.Codec:
  """Build the MT3 event codec (reference vocabularies.py:119-140)."""
  event_ranges = [
      event_codec.EventRange('pitch', MIN_MIDI_PITCH, MAX_MIDI_PITCH),
      # Velocity bin 0 is used for note-off.
      event_codec.EventRange('velocity', 0, vocab_config.num_velocity_bins),
      # Marks the end of the tie section at the start of a segment.
      event_codec.EventRange('tie', 0, 0),
      event_codec.EventRange('program', MIN_MIDI_PROGRAM, MAX_MIDI_PROGRAM),
      event_codec.EventRange('drum', MIN_MIDI_PITCH, MAX_MIDI_PITCH),
  ]
  return event_codec.Codec(
      max_shift_steps=(vocab_config.steps_per_second *
                       vocab_config.max_shift_seconds),
      steps_per_second=vocab_config.steps_per_second,
      event_ranges=event_ranges)


class GenericTokenVocabulary:
  """Vocabulary with pass-through encoding of codec indices."""

  def __init__(self, regular_ids: int, extra_ids: int = 0):
    self._num_special_tokens = NUM_SPECIAL_TOKENS
    self._num_regular_tokens = regular_ids
    self.extra_ids = extra_ids

  @property
  def eos_id(self) -> int:
    return EOS_ID

  @property
  def unk_id(self) -> int:
    return UNK_ID

  @property
  def pad_id(self) -> int:
    return PAD_ID

  @property
  def _base_vocab_size(self) -> int:
    return self._num_special_tokens + self._num_regular_tokens

  @property
  def vocab_size(self) -> int:
    return self._base_vocab_size + self.extra_ids

  def encode(self, token_ids: Sequence[int]) -> Sequence[int]:
    """Codec indices -> model ids (offset by the special tokens)."""
    encoded = []
    for token_id in token_ids:
      if not 0 <= token_id < self._num_regular_tokens:
        raise ValueError(
            f'token_id {token_id} does not fall within valid range of '
            f'[0, {self._num_regular_tokens})')
      encoded.append(int(token_id) + self._num_special_tokens)
    return encoded

  def encode_array(self, token_ids: np.ndarray) -> np.ndarray:
    token_ids = np.asarray(token_ids)
    if token_ids.size and (token_ids.min() < 0
                           or token_ids.max() >= self._num_regular_tokens):
      raise ValueError('token id out of range')
    return token_ids + self._num_special_tokens

  def decode(self, ids: Sequence[int]) -> Sequence[int]:
    """Model ids -> codec indices, truncating at (and including) first EOS.

    EOS becomes DECODED_EOS_ID; PAD/UNK/extra ids become DECODED_INVALID_ID.
    """
    decoded = []
    for i in ids:
      i = int(i)
      if i == EOS_ID:
        decoded.append(DECODED_EOS_ID)
        break
      elif i < self._num_special_tokens or i >= self._base_vocab_size:
        decoded.append(DECODED_INVALID_ID)
      else:
        decoded.append(i - self._num_special_tokens)
    return decoded

  def decode_array(self, ids: np.ndarray) -> np.ndarray:
    """Vectorized decode preserving array shape.

    Everything from the first EOS onward (along the last axis) becomes
    DECODED_EOS_ID; out-of-range ids become DECODED_INVALID_ID.  Matches the
    reference TF decode (vocabularies.py:233-266).
    """
    ids = np.asarray(ids)
    eos_and_after = np.cumsum(ids == EOS_ID, axis=-1) > 0
    valid = (ids >= self._num_special_tokens) & (ids < self._base_vocab_size)
    return np.where(
        eos_and_after, DECODED_EOS_ID,
        np.where(valid, ids - self._num_special_tokens, DECODED_INVALID_ID))

  def __eq__(self, other) -> bool:
    return (isinstance(other, GenericTokenVocabulary)
            and self.extra_ids == other.extra_ids
            and self._num_regular_tokens == other._num_regular_tokens)


def vocabulary_from_codec(codec: event_codec.Codec) -> GenericTokenVocabulary:
  return GenericTokenVocabulary(codec.num_classes,
                                extra_ids=DEFAULT_EXTRA_IDS)


def num_embeddings(vocabulary: GenericTokenVocabulary) -> int:
  """Vocabulary size rounded up to a multiple of 128 for TPU efficiency."""
  return 128 * math.ceil(vocabulary.vocab_size / 128)
