"""Prediction postprocessing: segment combination and event decoding.

Capability-parity rebuild of mt3/metrics_utils.py:47-146:
group segment predictions by example id, sort by start time, replay tokens
through the note decoding state machine with each segment's decode capped
at the next segment's start time (overlap resolution), and flush to a
NoteSequence.
"""

from __future__ import annotations

import collections
import functools
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import numpy as np

from mt3_tpu_torch.codec import event_codec, note_events, run_length
from mt3_tpu_torch.codec.vocabulary import DECODED_EOS_ID

CombineExamplesFn = Callable[[Sequence[Mapping[str, Any]]],
                             Mapping[str, Any]]


def trim_eos(tokens: np.ndarray) -> np.ndarray:
  """Remove DECODED_EOS_ID and everything after (reference tasks.py:58-63)."""
  tokens = np.asarray(tokens, dtype=np.int32)
  if DECODED_EOS_ID in tokens:
    tokens = tokens[:np.argmax(tokens == DECODED_EOS_ID)]
  return tokens


def combine_predictions_by_id(
    predictions: Sequence[Mapping[str, Any]],
    combine_predictions_fn: CombineExamplesFn,
) -> Mapping[Any, Mapping[str, Any]]:
  """Group predicted segments by 'unique_id' and combine each group."""
  predictions_by_id = collections.defaultdict(list)
  for pred in predictions:
    predictions_by_id[pred['unique_id']].append(pred)
  return {
      uid: combine_predictions_fn(preds)
      for uid, preds in predictions_by_id.items()
  }


def decode_and_combine_predictions(
    predictions: Sequence[Mapping[str, Any]],
    init_state_fn, begin_segment_fn, decode_tokens_fn, flush_state_fn,
) -> Tuple[Any, int, int]:
  """Decode a sorted sequence of segment predictions into one result.

  Each segment's decoding is capped at the next segment's start time so
  overlapping segments don't double-emit events
  (reference metrics_utils.py:100-111).
  """
  sorted_predictions = sorted(predictions,
                              key=lambda pred: pred['start_time'])
  state = init_state_fn()
  total_invalid_events = 0
  total_dropped_events = 0

  for pred_idx, pred in enumerate(sorted_predictions):
    begin_segment_fn(state)
    max_decode_time = None
    if pred_idx < len(sorted_predictions) - 1:
      max_decode_time = sorted_predictions[pred_idx + 1]['start_time']
    invalid_events, dropped_events = decode_tokens_fn(
        state, pred['est_tokens'], pred['start_time'], max_decode_time)
    total_invalid_events += invalid_events
    total_dropped_events += dropped_events

  return flush_state_fn(state), total_invalid_events, total_dropped_events


def event_predictions_to_ns(
    predictions: Sequence[Mapping[str, Any]],
    codec: event_codec.Codec,
    encoding_spec: note_events.NoteEncodingSpecType,
) -> Mapping[str, Any]:
  """Convert segment predictions to a combined NoteSequence result dict."""
  ns, total_invalid, total_dropped = decode_and_combine_predictions(
      predictions=predictions,
      init_state_fn=encoding_spec.init_decoding_state_fn,
      begin_segment_fn=encoding_spec.begin_decoding_segment_fn,
      decode_tokens_fn=functools.partial(
          run_length.decode_events,
          codec=codec,
          decode_event_fn=encoding_spec.decode_event_fn),
      flush_state_fn=encoding_spec.flush_decoding_state_fn)

  sorted_predictions = sorted(predictions,
                              key=lambda pred: pred['start_time'])
  raw_inputs = [pred['raw_inputs'] for pred in sorted_predictions
                if pred.get('raw_inputs') is not None]
  return {
      'raw_inputs': np.concatenate(raw_inputs, axis=0) if raw_inputs
                    else None,
      'start_times': [pred['start_time'] for pred in sorted_predictions],
      'est_ns': ns,
      'est_invalid_events': total_invalid,
      'est_dropped_events': total_dropped,
  }


def postprocess_prediction(
    decoded_tokens: np.ndarray,
    start_time: float,
    codec: event_codec.Codec,
    raw_inputs: Optional[np.ndarray] = None,
    unique_id: Any = 0,
) -> Mapping[str, Any]:
  """Build one segment-prediction dict (reference tasks.py:66-87).

  `decoded_tokens` are already codec indices (vocabulary.decode_array
  output).  Start time is rounded down to the nearest symbolic token step.
  """
  tokens = trim_eos(decoded_tokens)
  start_time -= start_time % (1 / codec.steps_per_second)
  return {
      'unique_id': unique_id,
      'raw_inputs': raw_inputs,
      'est_tokens': tokens,
      'start_time': start_time,
  }
