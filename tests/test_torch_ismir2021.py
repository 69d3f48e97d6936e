"""The ismir2021 flavour in the port against mt3_tpu, on the CPU.

ismir2021_config()'s vocabulary (127 velocity bins, 1664 tokens) and run
config (512-frame segments, 1024 targets, no ties, flat programs) at the
tiny preset's widths, with the JAX parameters carried across by
params.from_numpy_tree:
* teacher-forced logits within atol = rtol = 2e-4 at valid positions (the
  float32 tolerance tests/test_torch_train_model.py holds t5.forward to);
* the Transcriber's tokens and notes identical to JAX's on a 10 s clip
  (three 512-frame segments), in tests/test_torch_ismir2021_transcribe.py
  (the JAX decode compiles a program for each of its cache's 8 buckets,
  most of that file's time);
* a training batch of the flavour's pipeline, inline and from a segment
  cache, bit for bit equal to JAX's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mt3_tpu.codec import vocabulary as jax_vocabulary
from mt3_tpu.core import config as jax_config
from mt3_tpu.data import pipeline as jax_pipeline
from mt3_tpu.data import synth as jax_synth
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.codec import vocabulary
from mt3_tpu_torch.core import config as port_config
from mt3_tpu_torch.data import pipeline, synth
from mt3_tpu_torch.models import t5

torch.set_num_threads(2)

WIDTHS = ('emb_dim', 'num_heads', 'head_dim', 'mlp_dim',
          'num_encoder_layers', 'num_decoder_layers')


def _flavour(config_lib):
  """ismir2021_config() at the tiny preset's widths, dropout 0."""
  config = config_lib.ismir2021_config()
  tiny = config_lib.tiny_config().model
  return dataclasses.replace(config, model=dataclasses.replace(
      config.model, dropout_rate=0.0,
      **{k: getattr(tiny, k) for k in WIDTHS}))


@pytest.fixture(scope='module')
def models():
  jax_cfg = _flavour(jax_config)
  params, _ = jax_t5.init_params(jax.random.PRNGKey(0), jax_cfg.model)
  numpy_params = jax.tree_util.tree_map(np.asarray, params)
  return (jax_cfg, params, _flavour(port_config),
          params_lib.from_numpy_tree(numpy_params))


def test_flavour_is_the_jax_config():
  port, ref = port_config.ismir2021_config(), jax_config.ismir2021_config()
  assert dataclasses.asdict(port) == dataclasses.asdict(ref)
  assert port.model.vocab_size == 1664
  assert (port.run.inputs_length, port.run.targets_length) == (512, 1024)
  assert (port.vocab.num_velocity_bins, port.run.use_ties,
          port.run.program_granularity) == (127, False, 'flat')


def test_teacher_forced_logits_match_jax(models):
  jax_cfg, jax_params, cfg, params = models
  run, model = cfg.run, cfg.model
  rng = np.random.RandomState(0)
  targets = np.zeros((2, run.targets_length), np.int32)
  for row, n in enumerate((run.targets_length, 700)):
    targets[row, :n] = rng.randint(3, model.vocab_size, n)
  inputs = np.zeros_like(targets)
  inputs[:, 1:] = targets[:, :-1]
  frames = rng.randn(2, run.inputs_length, model.input_depth).astype(
      np.float32)
  want = np.asarray(jax_t5.forward(jax_params, jax_cfg.model, frames, inputs,
                                   targets))
  got = t5.forward(params, model, torch.from_numpy(frames),
                   torch.from_numpy(inputs), torch.from_numpy(targets))
  assert got.shape == (2, run.targets_length, model.vocab_size)
  valid = targets > 0
  np.testing.assert_allclose(got.detach().numpy()[valid], want[valid],
                             atol=2e-4, rtol=2e-4)


def _batch(lib, synth_lib, config_lib, vocab_lib, tmp_path, cached):
  config = config_lib.ismir2021_config()
  run = config.run
  codec = vocab_lib.build_codec(config.vocab)
  vocab = vocab_lib.vocabulary_from_codec(codec)
  source = synth_lib.PolyphonicSynthDataSource(
      num_examples=3, duration=8.192, seed=1000, programs=(0,),
      max_instruments=1)
  pipe_cfg = lib.TrainPipelineConfig(
      inputs_length=run.inputs_length, targets_length=run.targets_length,
      batch_size=2, include_ties=run.use_ties,
      program_granularity=run.program_granularity, seed=0)
  if not cached:
    return next(lib.train_batches(source.examples(), config.spectrogram,
                                  codec, vocab, pipe_cfg))
  lib.build_segment_cache(source.examples(), config.spectrogram, codec,
                          str(tmp_path), include_ties=run.use_ties)
  return next(lib.train_batches_from_cache(str(tmp_path), codec, vocab,
                                           pipe_cfg))


@pytest.mark.parametrize('cached', [False, True], ids=['inline', 'cache'])
def test_train_batch_equals_jax(tmp_path, cached):
  want = _batch(jax_pipeline, jax_synth, jax_config, jax_vocabulary,
                tmp_path / 'jax', cached)
  got = _batch(pipeline, synth, port_config, vocabulary, tmp_path / 'port',
               cached)
  assert sorted(got) == sorted(want)
  assert got['encoder_input_frames'].shape == (2, 512, 128)
  assert got['decoder_target_tokens'].shape == (2, 1024)
  for key in want:
    assert got[key].dtype == want[key].dtype, key
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  # Velocities other than 0 and 1 of the 127-bin codec in the targets.
  codec = vocabulary.build_codec(port_config.ismir2021_config().vocab)
  lo, hi = codec.event_type_range('velocity')
  events = got['decoder_target_tokens'] - vocabulary.NUM_SPECIAL_TOKENS
  assert ((events > lo + 1) & (events <= hi)).any()
