"""The plain reference against the port at tiny sizes on the CPU: the
same numbers from independent code (the tests may import both; the
reference itself imports nothing of the port)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from gpubench import weights
from gpubench.reference import logmel, model, notes
from gpubench.tests import tiny

REPO = pathlib.Path(__file__).resolve().parents[2]


def _cfg(name):
  return json.loads((REPO / 'gpubench' / 'configs' / f'{name}.json')
                    .read_text())


def test_logmel_matches_the_port_plain_version():
  from mt3_tpu_torch.core import config
  from mt3_tpu_torch.ops import spectrogram
  audio = torch.randn(2, 128 * 16, generator=torch.Generator().manual_seed(0))
  want = spectrogram.compute_logmel(audio, config.mt3_config().spectrogram)
  got = logmel.logmel(audio, _cfg('mt3')['spectrogram'])
  assert got.shape == want.shape
  assert float((got - want).abs().max()) < 2e-3


def test_mel_matrix_is_the_port_one():
  from mt3_tpu_torch.ops import mel
  spec = _cfg('mt3')['spectrogram']
  np.testing.assert_array_equal(
      logmel.spec_mel_matrix(spec),
      mel.linear_to_mel_weight_matrix(512, 1025, 16000, 20.0, 7600.0))


def test_teacher_forced_logits_match_the_port_float32():
  from mt3_tpu_torch.models import t5
  from gpubench import program
  cfg = _cfg('mt3')
  cfg['model'] = dict(tiny.TINY_MODEL)
  cfg['dtype'] = 'float32'
  cfg['run'].update(inputs_length=8, targets_length=16)
  port = program.config(cfg)
  params = weights.make(cfg['model'], 3, torch.device('cpu'))
  gen = torch.Generator().manual_seed(1)
  mel = torch.randn(2, 8, 512, generator=gen)
  targets = torch.randint(3, 1536, (2, 16), generator=gen)
  inputs = model.shift_right(targets)
  want = t5.forward(params, port.model, mel, inputs.to(torch.int32),
                    targets.to(torch.int32))
  got = model.decode(params, cfg['model'],
                     model.encode(params, cfg['model'], mel), inputs)
  assert float((got - want).abs().max()) < 1e-4


def _events(rng, vocab, n):
  """Token ids biased to valid events: shifts, pitches, velocities,
  programs, drums, ties, and a few unused ids."""
  steps = vocab['steps_per_second'] * vocab['max_shift_seconds'] + 1
  pitch = 3 + steps
  velocity = pitch + 128
  tie = velocity + vocab['num_velocity_bins'] + 1
  program = tie + 1
  kinds = rng.choice(6, size=n, p=[0.35, 0.3, 0.15, 0.05, 0.05, 0.1])
  out = []
  for kind in kinds:
    if kind == 0:
      out.append(3 + rng.integers(1, 20))
    elif kind == 1:
      out.append(pitch + rng.integers(55, 70))
    elif kind == 2:
      out.append(velocity + rng.integers(0, vocab['num_velocity_bins'] + 1))
    elif kind == 3:
      out.append(tie)
    elif kind == 4:
      out.append(program + rng.integers(0, 3))
    else:
      out.append(rng.integers(2, 1536))
  return out


@pytest.mark.parametrize('name', ['mt3', 'ismir2021'])
@pytest.mark.parametrize('seed', range(6))
def test_notes_match_the_port_postprocess(name, seed):
  from mt3_tpu_torch.codec import note_events, vocabulary
  from mt3_tpu_torch.core import config
  from mt3_tpu_torch.infer import postprocess
  cfg = _cfg(name)
  port = config.CONFIG_FACTORIES[name]()
  codec = vocabulary.build_codec(port.vocab)
  vocab = vocabulary.vocabulary_from_codec(codec)
  spec = (note_events.NoteEncodingWithTiesSpec if port.run.use_ties
          else note_events.NoteEncodingSpec)
  rng = np.random.default_rng(seed)
  length = cfg['run']['inputs_length']
  fps = 16000 / 128
  segments = []
  for i in range(5):
    tokens = _events(rng, cfg['vocab'], 200)
    if rng.random() < 0.4:
      tokens[rng.integers(0, 200)] = 1   # an EOS
    segments.append((i * length / fps, tokens))
  predictions = [postprocess.postprocess_prediction(
      vocab.decode_array(np.asarray(t)), s, codec) for s, t in segments]
  result = postprocess.event_predictions_to_ns(predictions, codec, spec)
  want = [(n.pitch, n.velocity, n.start_time, n.end_time, n.program,
           n.is_drum, n.instrument) for n in result['est_ns'].notes]
  got, invalid, dropped = notes.decode(segments, cfg['vocab'])
  assert want, 'the tokens should make notes'
  assert got == want
  assert (invalid, dropped) == (result['est_invalid_events'],
                                result['est_dropped_events'])
