"""The port's offline segment cache against mt3_tpu's.

* build_segment_cache writes shards byte-identical to the JAX package's
  from the same examples, shard for shard.
* train_batches_from_cache yields bit-identical batches, preloaded and
  shard-shuffled (with and without mixing), past one epoch; each package
  reads a cache written by the other as well as its own.
* cached_segments and preload_segments decode the same segments;
  split_to_inputs_length and prepare_train_example agree.

The JAX side reads through its own loader (its Python reader unless
native/libmt3_native.so was built); the port through its native one.  No wall-clock check: the JAX
package's test_cached_epoch_faster_than_inline times a loaded host.
"""

import itertools

import numpy as np
import pytest

from mt3_tpu.codec import vocabulary as jax_vocabulary
from mt3_tpu.core import config as jax_config
from mt3_tpu.data import datasets as jax_datasets
from mt3_tpu.data import pipeline as jax_pipeline
from mt3_tpu_torch.codec import vocabulary
from mt3_tpu_torch.core import config
from mt3_tpu_torch.data import datasets, pipeline, tfrecord

SEGMENT_KEYS = ('inputs', 'targets', 'input_event_start_indices',
                'input_event_end_indices', 'state_events',
                'input_state_event_indices')


def _setup(model):
  jax_cfg = jax_config.CONFIG_FACTORIES[model]()
  cfg = config.CONFIG_FACTORIES[model]()
  jax_codec = jax_vocabulary.build_codec(jax_cfg.vocab)
  codec = vocabulary.build_codec(cfg.vocab)
  return dict(
      jax=(jax_cfg, jax_codec, jax_vocabulary.vocabulary_from_codec(jax_codec),
           jax_pipeline, jax_datasets),
      port=(cfg, codec, vocabulary.vocabulary_from_codec(codec), pipeline,
            datasets))


def _examples(module, n=3, duration=3.0, seed=1000):
  """Polysynth clips of `duration` seconds: one cache segment each (the
  cache splits at 2000 frames, 16 s)."""
  source = module.resolve_data_source(f'polysynth:{n}:{seed}')
  source.duration = duration
  return list(source.examples())


@pytest.fixture(scope='module')
def caches(tmp_path_factory):
  """Caches of the same 5 clips by each package, 2 segments a shard."""
  root = tmp_path_factory.mktemp('caches')
  sides = _setup('mt3')
  out = {}
  for side, (cfg, codec, _, pipe, data) in sides.items():
    directory = str(root / side)
    n = pipe.build_segment_cache(
        iter(_examples(data, n=5)), cfg.spectrogram, codec, directory,
        shard_size=2)
    out[side] = (directory, n)
  return out


def test_caches_are_byte_identical_shard_for_shard(caches):
  import os
  (ours, n_ours), (theirs, n_theirs) = caches['port'], caches['jax']
  assert n_ours == n_theirs == 5
  names = sorted(os.listdir(ours))
  assert names == sorted(os.listdir(theirs)) == [
      'cache-00000.tfrecord', 'cache-00001.tfrecord', 'cache-00002.tfrecord']
  for name in names:
    with open(os.path.join(ours, name), 'rb') as a, open(
        os.path.join(theirs, name), 'rb') as b:
      assert a.read() == b.read(), name


@pytest.mark.parametrize('max_tokens', (2000, 100))
def test_split_segments_cache_identically(tmp_path, max_tokens):
  """Clips longer than the cache's split length (forced small here through
  split_tokens' default) give several self-contained records each."""
  sides = _setup('tiny')
  records = {}
  for side, (cfg, codec, _, pipe, data) in sides.items():
    features = pipe.tokenize_example(
        *(lambda ex: (ex['sequence'], ex['audio']))(
            _examples(data, n=1, duration=2.0)[0]),
        cfg.spectrogram, codec)
    records[side] = [pipe._segment_to_record(s) for s in pipe.split_tokens(
        features, max_tokens=max_tokens)]
  assert records['port'] == records['jax']
  assert len(records['port']) == (1 if max_tokens == 2000 else 3)
  for record in records['port']:
    ours = pipeline._record_to_segment(tfrecord.parse_example(record))
    theirs = jax_pipeline._record_to_segment(
        tfrecord._parse_example_py(record))
    for key in SEGMENT_KEYS:
      assert ours[key].dtype == theirs[key].dtype, key
      np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


@pytest.mark.parametrize('shuffled', (False, True))
def test_cached_segments_identical(caches, shuffled):
  directory = caches['port'][0]
  ours = list(pipeline.cached_segments(
      directory, np.random.RandomState(3) if shuffled else None,
      shuffle_buffer=3))
  theirs = list(jax_pipeline.cached_segments(
      directory, np.random.RandomState(3) if shuffled else None,
      shuffle_buffer=3))
  assert len(ours) == len(theirs) == 5
  for a, b in zip(ours, theirs):
    for key in SEGMENT_KEYS:
      np.testing.assert_array_equal(a[key], b[key], err_msg=key)
  preloaded = pipeline.preload_segments(directory)
  if not shuffled:
    for a, b in zip(preloaded, ours):
      for key in SEGMENT_KEYS:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize('written_by', ('port', 'jax'))
@pytest.mark.parametrize('mix', (None, 3))
@pytest.mark.parametrize('preload', (True, False))
def test_batches_from_cache_bit_identical(caches, preload, mix, written_by):
  sides = _setup('mt3')
  directory = caches[written_by][0]
  run = sides['port'][0].run
  kwargs = dict(inputs_length=run.inputs_length,
                targets_length=run.targets_length, batch_size=4,
                max_examples_per_mix=mix, seed=11)
  iterators = []
  for cfg, codec, vocab, pipe, _ in (sides['port'], sides['jax']):
    iterators.append(pipe.train_batches_from_cache(
        directory, codec, vocab, pipe.TrainPipelineConfig(**kwargs),
        preload=preload))
  # 3 batches of 4 run past the first epoch of 5 segments.
  for a, b in itertools.islice(zip(*iterators), 3):
    assert a.keys() == b.keys()
    for key in a:
      assert a[key].dtype == b[key].dtype, key
      np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert a['encoder_input_frames'].shape == (4, run.inputs_length, 128)


def test_empty_cache_raises(tmp_path):
  sides = _setup('tiny')
  cfg, codec, vocab, _, _ = sides['port']
  pipe_cfg = pipeline.TrainPipelineConfig(
      inputs_length=8, targets_length=16, batch_size=1)
  for preload in (True, False):
    with pytest.raises(ValueError):
      next(pipeline.train_batches_from_cache(str(tmp_path), codec, vocab,
                                             pipe_cfg, preload=preload))


@pytest.mark.parametrize('length', (256, 100))
def test_split_to_inputs_length_identical(length):
  sides = _setup('mt3')
  out = {}
  for side, (cfg, codec, _, pipe, data) in sides.items():
    ex = _examples(data, n=1, duration=2.5, seed=77)[0]
    features = pipe.tokenize_example(ex['sequence'], ex['audio'],
                                     cfg.spectrogram, codec)
    features['unique_id'] = 5
    out[side] = pipe.split_to_inputs_length(features, length)
  assert len(out['port']) == len(out['jax']) == -(-313 // length)
  for a, b in zip(out['port'], out['jax']):
    assert a['num_valid_frames'] == b['num_valid_frames']
    assert a['unique_id'] == b['unique_id'] == 5
    assert a['inputs'].shape == (length, 128)
    np.testing.assert_array_equal(a['inputs'], b['inputs'])
    np.testing.assert_array_equal(a['input_times'], b['input_times'])


@pytest.mark.parametrize('targets_length', (1024, 16))
def test_prepare_train_example_identical(targets_length):
  sides = _setup('mt3')
  out = {}
  for side, (cfg, codec, vocab, pipe, data) in sides.items():
    ex = _examples(data, n=1, duration=3.0, seed=5)[0]
    features = pipe.tokenize_example(ex['sequence'], ex['audio'],
                                     cfg.spectrogram, codec)
    rng = np.random.RandomState(2)
    out[side] = [pipe.prepare_train_example(
        features, codec, vocab, 256, targets_length, rng) for _ in range(3)]
  for a, b in zip(out['port'], out['jax']):
    if b is None:   # too many targets for the short length: skipped
      assert a is None and targets_length == 16
      continue
    assert a.keys() == b.keys()
    for key in a:
      np.testing.assert_array_equal(a[key], b[key], err_msg=key)
  if targets_length == 1024:
    assert all(a is not None for a in out['port'])
