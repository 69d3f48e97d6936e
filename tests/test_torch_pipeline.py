"""The port's copies of the host training data path against mt3_tpu.

* Each copied function or class is pinned to its original: its source
  equals the JAX package's with `mt3_tpu.` imports rewritten to
  `mt3_tpu_torch.` and reference paths shortened, as the copies were made.
* The copied pipeline, mixing and synthetic source yield batches
  bit-identical to mt3_tpu.data.pipeline.train_batches for the same seed.
* frames_to_logmel on the CPU equals the JAX package's within atol 1e-4
  in the log domain, the tolerance of tests/test_torch_spectrogram.py for
  the same matmuls.
"""

import dataclasses
import inspect
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt3_tpu.codec import vocabulary as jax_vocabulary
from mt3_tpu.core import config as jax_config
from mt3_tpu.core import sustain as jax_sustain
from mt3_tpu.data import datasets as jax_datasets
from mt3_tpu.data import mixing as jax_mixing
from mt3_tpu.data import pipeline as jax_pipeline
from mt3_tpu.ops import spectrogram as jax_spectrogram
from mt3_tpu_torch.codec import vocabulary
from mt3_tpu_torch.core import config, sustain
from mt3_tpu_torch.data import datasets, mixing, pipeline
from mt3_tpu_torch.ops import spectrogram

torch.set_num_threads(2)

PIPELINE_COPIES = (
    'audio_to_frames', 'tokenize_example', 'split_tokens',
    'select_random_chunk', 'map_midi_programs', 'encode_targets',
    'crop_and_rle', 'finalize_train_example', '_stack_batch', 'prefetch',
    'TrainPipelineConfig', 'train_batches', '_batches_over_epochs')
COPIES = ([(pipeline, jax_pipeline, name) for name in PIPELINE_COPIES]
          + [(datasets, jax_datasets, name)
             for name in ('DataSource', 'SyntheticDataSource')])
WHOLE_MODULES = ((sustain, jax_sustain), (mixing, jax_mixing))


_REFERENCE_CHECKOUT = re.compile(r'/[^\s:()]*/reference/mt3/')


def _rewritten(source):
  """The JAX package's source as the copies were made from it: imports
  rewritten, absolute paths into the reference checkout cut to mt3/."""
  return _REFERENCE_CHECKOUT.sub(
      'mt3/', source.replace('mt3_tpu.', 'mt3_tpu_torch.'))


@pytest.mark.parametrize('ours,theirs,name', COPIES,
                         ids=[f'{o.__name__.split(".")[-1]}.{n}'
                              for o, _, n in COPIES])
def test_copies_are_pinned_to_their_originals(ours, theirs, name):
  assert inspect.getsource(getattr(ours, name)) == _rewritten(
      inspect.getsource(getattr(theirs, name)))


@pytest.mark.parametrize('ours,theirs', WHOLE_MODULES,
                         ids=[m.__name__ for m, _ in WHOLE_MODULES])
def test_copied_modules_are_pinned(ours, theirs):
  """Whole-module copies: identical but for the first docstring line."""
  mine = inspect.getsource(ours).splitlines()
  orig = _rewritten(inspect.getsource(theirs)).splitlines()
  assert mine[1:] == orig[1:]
  assert mine[0].startswith(orig[0].rstrip('.'))


def _both_codecs(name):
  jax_cfg = jax_config.CONFIG_FACTORIES[name]()
  cfg = config.CONFIG_FACTORIES[name]()
  jax_codec = jax_vocabulary.build_codec(jax_cfg.vocab)
  codec = vocabulary.build_codec(cfg.vocab)
  return (jax_cfg, jax_codec, jax_vocabulary.vocabulary_from_codec(jax_codec),
          cfg, codec, vocabulary.vocabulary_from_codec(codec))


@pytest.mark.parametrize('model,mix', (('mt3', None), ('mt3', 3),
                                       ('tiny', None)))
def test_train_batches_bit_identical(model, mix):
  jax_cfg, jax_codec, jax_vocab, cfg, codec, vocab = _both_codecs(model)
  run = cfg.run
  pipe_kwargs = dict(
      inputs_length=run.inputs_length, targets_length=run.targets_length,
      batch_size=2, onsets_only=run.onsets_only, include_ties=run.use_ties,
      program_granularity=run.program_granularity,
      max_examples_per_mix=mix, seed=5)
  source = datasets.resolve_data_source('synthetic', cfg.spectrogram,
                                        num_examples=3, seed=11)
  jax_source = jax_datasets.resolve_data_source(
      'synthetic', jax_cfg.spectrogram, num_examples=3, seed=11)
  ours = pipeline.train_batches(
      source.examples(), cfg.spectrogram, codec, vocab,
      pipeline.TrainPipelineConfig(**pipe_kwargs))
  theirs = jax_pipeline.train_batches(
      jax_source.examples(), jax_cfg.spectrogram, jax_codec, jax_vocab,
      jax_pipeline.TrainPipelineConfig(**pipe_kwargs))
  # Three batches run past the first epoch of 3 examples.
  for a, b in itertools.islice(zip(ours, theirs), 3):
    assert a.keys() == b.keys()
    for key in a:
      assert a[key].dtype == b[key].dtype, key
      np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert a['encoder_input_frames'].shape == (
        2, run.inputs_length, cfg.spectrogram.hop_width)
    assert (a['decoder_loss_weights'].sum(1) > 1).all()


def test_prefetch_transform_and_order():
  items = list(pipeline.prefetch(iter(range(20)), size=3,
                                 transform=lambda x: x * 2))
  assert items == [2 * i for i in range(20)]


def test_synthetic_source_identical_and_other_specs_raise():
  ours = list(datasets.SyntheticDataSource(num_examples=2, seed=4).examples())
  theirs = list(jax_datasets.SyntheticDataSource(num_examples=2,
                                                 seed=4).examples())
  for a, b in zip(ours, theirs):
    np.testing.assert_array_equal(a['audio'], b['audio'])
    assert ([dataclasses.astuple(n) for n in a['sequence'].notes]
            == [dataclasses.astuple(n) for n in b['sequence'].notes])
  for spec in ('polysynth:4', 'corpus.tfrecord', '/some/directory'):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
      datasets.resolve_data_source(spec)


def test_frames_to_logmel_matches_jax():
  cfg = config.SpectrogramConfig()
  frames = (np.random.RandomState(0).randn(2, 64, cfg.hop_width)
            * 0.3).astype(np.float32)
  want = np.asarray(jax_spectrogram.frames_to_logmel(
      jnp.asarray(frames), jax_config.SpectrogramConfig()))
  got = spectrogram.frames_to_logmel(torch.from_numpy(frames), cfg).numpy()
  assert got.shape == want.shape == (2, 64, cfg.num_mel_bins)
  np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
