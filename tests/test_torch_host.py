"""The PyTorch port's copies of the host-side modules vs mt3_tpu.

Vocabulary, run-length and note-event decoding, segment stitching and MIDI
writing must give identical results: the same token arrays go through both
packages and the notes and MIDI bytes are compared exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mt3_tpu.codec import event_codec as jax_event_codec
from mt3_tpu.codec import note_events as jax_note_events
from mt3_tpu.codec import vocabulary as jax_vocabulary
from mt3_tpu.core import config as jax_config
from mt3_tpu.core import midi_io as jax_midi_io
from mt3_tpu.infer import postprocess as jax_postprocess
from mt3_tpu.ops import mel as jax_mel
from mt3_tpu_torch.codec import event_codec, note_events, vocabulary
from mt3_tpu_torch.core import config, midi_io
from mt3_tpu_torch.infer import postprocess
from mt3_tpu_torch.ops import mel

torch.set_num_threads(2)

SPECS = {'ties': 'NoteEncodingWithTiesSpec', 'plain': 'NoteEncodingSpec',
         'onsets': 'NoteOnsetEncodingSpec'}


def _model_ids(codec, rng, n_events, with_tie, velocity_bins):
  """A plausible model-id stream: tie section, then shifted note events."""
  events = []
  if with_tie:
    for _ in range(rng.randint(1, 4)):
      events += [event_codec.Event('program', int(rng.randint(0, 128))),
                 event_codec.Event('pitch', int(rng.randint(21, 109)))]
    events.append(event_codec.Event('tie', 0))
  for _ in range(n_events):
    if rng.rand() < 0.5:
      events.append(event_codec.Event('shift', int(rng.randint(1, 60))))
    events.append(event_codec.Event('velocity',
                                    int(rng.randint(0, velocity_bins + 1))))
    if with_tie:
      events.append(event_codec.Event('program', int(rng.randint(0, 128))))
    kind = 'drum' if with_tie and rng.rand() < 0.1 else 'pitch'
    events.append(event_codec.Event(kind, int(rng.randint(21, 109))))
  ids = [codec.encode_event(e) + vocabulary.NUM_SPECIAL_TOKENS
         for e in events]
  return np.array(ids + [vocabulary.EOS_ID], np.int32)


def _both(vocab_config_kwargs):
  return (jax_vocabulary.build_codec(
              jax_config.VocabularyConfig(**vocab_config_kwargs)),
          vocabulary.build_codec(config.VocabularyConfig(**vocab_config_kwargs)))


CASES = {
    # name: (velocity bins, encoding spec, segments, random ids)
    'mt3_ties': (1, 'ties', 3, False),
    'ismir_plain': (127, 'plain', 2, False),
    'onsets': (1, 'onsets', 2, False),
    'random_ids': (1, 'ties', 2, True),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_decode_to_notes_and_midi_identical(case):
  velocity_bins, spec, n_segments, random_ids = CASES[case]
  jax_codec, codec = _both({'num_velocity_bins': velocity_bins})
  jax_vocab = jax_vocabulary.vocabulary_from_codec(jax_codec)
  vocab = vocabulary.vocabulary_from_codec(codec)
  rng = np.random.RandomState(sorted(CASES).index(case))
  length = 200
  rows = []
  for _ in range(n_segments):
    if random_ids:
      row = rng.randint(0, vocab.vocab_size, size=length).astype(np.int32)
    else:
      row = _model_ids(codec, rng, 25, spec == 'ties', velocity_bins)[:length]
      row = np.pad(row, (0, length - row.size))
    rows.append(row)
  ids = np.stack(rows)

  decoded = vocab.decode_array(ids)
  np.testing.assert_array_equal(decoded, jax_vocab.decode_array(ids))

  start_times = [2.048 * i for i in range(n_segments)]
  preds = [postprocess.postprocess_prediction(r, t, codec)
           for r, t in zip(decoded, start_times)]
  jax_preds = [jax_postprocess.postprocess_prediction(r, t, jax_codec)
               for r, t in zip(decoded, start_times)]
  result = postprocess.event_predictions_to_ns(
      preds, codec, getattr(note_events, SPECS[spec]))
  jax_result = jax_postprocess.event_predictions_to_ns(
      jax_preds, jax_codec, getattr(jax_note_events, SPECS[spec]))
  for key in ('est_invalid_events', 'est_dropped_events', 'start_times'):
    assert result[key] == jax_result[key]
  notes = [dataclasses.astuple(n) for n in result['est_ns'].notes]
  assert notes == [dataclasses.astuple(n)
                   for n in jax_result['est_ns'].notes]
  if not random_ids:
    assert notes
  assert (midi_io.note_sequence_to_midi(result['est_ns'])
          == jax_midi_io.note_sequence_to_midi(jax_result['est_ns']))


@pytest.mark.parametrize('name', sorted(config.CONFIG_FACTORIES))
def test_configs_and_vocab_sizes(name):
  ours = config.CONFIG_FACTORIES[name]()
  theirs = jax_config.CONFIG_FACTORIES[name]()
  assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
  codec = vocabulary.build_codec(ours.vocab)
  jax_codec = jax_vocabulary.build_codec(theirs.vocab)
  assert codec.num_classes == jax_codec.num_classes
  assert codec.event_types == jax_codec.event_types
  assert (vocabulary.num_embeddings(vocabulary.vocabulary_from_codec(codec))
          == jax_vocabulary.num_embeddings(
              jax_vocabulary.vocabulary_from_codec(jax_codec)))


def test_event_codec_round_trip():
  jax_codec, codec = _both({})
  for index in range(0, codec.num_classes, 7):
    event = codec.decode_event_index(index)
    assert dataclasses.astuple(event) == dataclasses.astuple(
        jax_codec.decode_event_index(index))
    assert codec.encode_event(event) == index
  assert isinstance(event, event_codec.Event)
  assert not isinstance(event, jax_event_codec.Event)


def test_midi_read_back_identical():
  jax_codec, codec = _both({'num_velocity_bins': 1})
  rng = np.random.RandomState(9)
  ids = _model_ids(codec, rng, 40, True, 1)
  pred = postprocess.postprocess_prediction(
      vocabulary.vocabulary_from_codec(codec).decode_array(ids), 0.0, codec)
  ns = postprocess.event_predictions_to_ns(
      [pred], codec, note_events.NoteEncodingWithTiesSpec)['est_ns']
  data = midi_io.note_sequence_to_midi(ns)
  ours = midi_io.midi_to_note_sequence(data)
  theirs = jax_midi_io.midi_to_note_sequence(data)
  assert ([dataclasses.astuple(n) for n in ours.notes]
          == [dataclasses.astuple(n) for n in theirs.notes])
  del jax_codec


def test_mel_matrix_identical():
  kwargs = dict(num_mel_bins=512, num_spectrogram_bins=1025,
                sample_rate=16000, lower_edge_hertz=20.0,
                upper_edge_hertz=7600.0)
  np.testing.assert_array_equal(mel.linear_to_mel_weight_matrix(**kwargs),
                                jax_mel.linear_to_mel_weight_matrix(**kwargs))
