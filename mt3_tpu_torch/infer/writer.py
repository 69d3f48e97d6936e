"""Offline inference output writer.

Rebuild of mt3/inference.py:34-138
(write_inferences_to_file): group segment predictions by example id,
decode to NoteSequences, and write JSON lines {id, est_notes} compatible
with the reference's output schema (est_notes = list of note tuples).
"""

from __future__ import annotations

import functools
import json
from typing import Any, Iterable, Mapping, Optional, Sequence

from mt3_tpu_torch.codec import event_codec, note_events
from mt3_tpu_torch.core.note_sequence import NoteSequence
from mt3_tpu_torch.infer import postprocess


def note_sequence_to_dict(ns: NoteSequence) -> list:
  """NoteSequence -> list of [start, end, pitch, velocity, program, is_drum]."""
  return [[round(n.start_time, 6), round(n.end_time, 6), n.pitch,
           n.velocity, n.program, bool(n.is_drum)]
          for n in ns.sorted_notes()]


def dict_to_note_sequence(notes: Sequence[Sequence]) -> NoteSequence:
  ns = NoteSequence()
  for start, end, pitch, velocity, program, is_drum in notes:
    ns.add_note(pitch=int(pitch), velocity=int(velocity),
                start_time=float(start), end_time=float(end),
                program=int(program), is_drum=bool(is_drum))
  ns.total_time = max([n.end_time for n in ns.notes], default=0.0)
  note_events.assign_instruments(ns)
  return ns


def write_inferences_to_file(
    path: str,
    predictions: Iterable[Mapping[str, Any]],
    codec: event_codec.Codec,
    onsets_only: bool = False,
    use_ties: bool = True,
    extra_fields: Optional[Mapping[Any, Mapping[str, Any]]] = None,
) -> int:
  """Write combined per-example transcriptions as JSON lines.

  `predictions` are segment dicts ('unique_id', 'est_tokens',
  'start_time').  Returns the number of examples written.
  """
  if onsets_only:
    encoding_spec = note_events.NoteOnsetEncodingSpec
  elif use_ties:
    encoding_spec = note_events.NoteEncodingWithTiesSpec
  else:
    encoding_spec = note_events.NoteEncodingSpec

  combined = postprocess.combine_predictions_by_id(
      predictions=list(predictions),
      combine_predictions_fn=functools.partial(
          postprocess.event_predictions_to_ns,
          codec=codec, encoding_spec=encoding_spec))

  count = 0
  with open(path, 'w') as f:
    for uid in sorted(combined.keys(), key=str):
      result = combined[uid]
      record = {
          'id': uid if isinstance(uid, (str, int)) else str(uid),
          'est_notes': note_sequence_to_dict(result['est_ns']),
          'est_invalid_events': result['est_invalid_events'],
          'est_dropped_events': result['est_dropped_events'],
      }
      if extra_fields and uid in extra_fields:
        record.update(extra_fields[uid])
      f.write(json.dumps(record) + '\n')
      count += 1
  return count
