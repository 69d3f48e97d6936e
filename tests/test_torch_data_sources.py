"""The port's data sources against mt3_tpu's: the same examples, bit for bit.

* datasets, program_maps, synth and the two scripts are whole copies of
  the JAX package's modules (imports rewritten to `mt3_tpu_torch.`,
  reference paths shortened), pinned here.
* Program lookups agree for every instrument name, and both raise on an
  unknown one.
* The polyphonic synth composes the same notes and renders the same audio.
* Each reference schema (wav_proto, samples_proto, wav_tracks, mix_tracks),
  written by the port, gives the same notes and audio through both
  packages' ReferenceTFRecordDataSource, pitch-bend skipping and shard
  globs included.
* LocalPairsDataSource, MaestroDataSource (v1 row and v3 column JSON) and
  TFRecordDataSource give the same examples; MixtureSource draws the same
  sources in the same order for a seed.
* The scripts print and write the same output.

Clips are 0.5-3 s so the file stays well under 40 s.
"""

import dataclasses
import inspect
import io
import json
import re
import wave

import numpy as np
import pytest

from mt3_tpu.data import datasets as jax_datasets
from mt3_tpu.data import program_maps as jax_program_maps
from mt3_tpu.data import synth as jax_synth
from mt3_tpu.scripts import dump_task as jax_dump_task
from mt3_tpu.scripts import extract_monophonic_examples as jax_mono
from mt3_tpu_torch.core import midi_io, noteseq_proto
from mt3_tpu_torch.core.config import SpectrogramConfig, VocabularyConfig
from mt3_tpu_torch.core.note_sequence import Note, NoteSequence, PitchBend
from mt3_tpu_torch.data import datasets, program_maps, synth, tfrecord
from mt3_tpu_torch.scripts import dump_task
from mt3_tpu_torch.scripts import extract_monophonic_examples as mono

_REFERENCE_CHECKOUT = re.compile(r'/[^\s:()]*/reference/mt3/')

WHOLE_MODULES = ((datasets, jax_datasets), (program_maps, jax_program_maps),
                 (synth, jax_synth), (dump_task, jax_dump_task),
                 (mono, jax_mono))


def _rewritten(source):
  return _REFERENCE_CHECKOUT.sub(
      'mt3/', source.replace('mt3_tpu.', 'mt3_tpu_torch.'))


@pytest.mark.parametrize('ours,theirs', WHOLE_MODULES,
                         ids=[m.__name__ for m, _ in WHOLE_MODULES])
def test_copied_modules_are_pinned(ours, theirs):
  mine = inspect.getsource(ours).splitlines()
  orig = _rewritten(inspect.getsource(theirs)).splitlines()
  assert mine[1:] == orig[1:]
  assert mine[0].startswith(orig[0].rstrip('.'))


def _notes(ns):
  return [dataclasses.astuple(n) for n in ns.notes]


def _assert_examples_equal(ours, theirs):
  assert len(ours) == len(theirs) > 0
  for a, b in zip(ours, theirs):
    assert a['sequence'].id == b['sequence'].id
    assert a['sequence'].total_time == b['sequence'].total_time
    assert _notes(a['sequence']) == _notes(b['sequence'])
    assert a['audio'].dtype == b['audio'].dtype == np.float32
    np.testing.assert_array_equal(a['audio'], b['audio'])


# ---------------------------------------------------------------------------
# Registry and program lookups
# ---------------------------------------------------------------------------
def test_dataset_registry_matches_jax():
  assert sorted(datasets.ALL_DATASET_CONFIGS) == sorted(
      jax_datasets.ALL_DATASET_CONFIGS)
  for name, cfg in datasets.ALL_DATASET_CONFIGS.items():
    theirs = jax_datasets.ALL_DATASET_CONFIGS[name]
    assert (cfg.schema, cfg.train_split, cfg.train_eval_split, cfg.notes) == (
        theirs.schema, theirs.train_split, theirs.train_eval_split,
        theirs.notes)
    assert ([dataclasses.astuple(s) for s in cfg.infer_eval_splits]
            == [dataclasses.astuple(s) for s in theirs.infer_eval_splits])
    assert ([dataclasses.astuple(s) for s in cfg.track_specs]
            == [dataclasses.astuple(s) for s in theirs.track_specs])
  assert datasets.MIXTURE_DATASET_NAMES == jax_datasets.MIXTURE_DATASET_NAMES
  assert datasets.construct_task_name('maestrov3', task_suffix='train') == (
      jax_datasets.construct_task_name('maestrov3', task_suffix='train'))


LOOKUPS = (
    ('guitarset_instrument_to_program', ['Clean Guitar']),
    ('urmp_instrument_to_program',
     sorted(jax_program_maps._URMP_INSTRUMENT_PROGRAMS)),
    ('slakh_class_to_program_and_is_drum',
     sorted(jax_program_maps._SLAKH_CLASS_PROGRAMS) + ['Drums']))


@pytest.mark.parametrize('name,instruments', LOOKUPS,
                         ids=[n for n, _ in LOOKUPS])
def test_program_lookups_agree_for_every_instrument(name, instruments):
  ours, theirs = getattr(program_maps, name), getattr(jax_program_maps, name)
  for instrument in instruments:
    assert ours(instrument) == theirs(instrument), instrument
  for unknown in ('Kazoo', ''):
    with pytest.raises(ValueError):
      ours(unknown)
    with pytest.raises(ValueError):
      theirs(unknown)


def _track(module, pitch, program=0, bend=False):
  ns = module.NoteSequence(total_time=1.0)
  ns.notes = [module.Note(pitch=pitch, velocity=90, start_time=0.1,
                          end_time=0.8, program=program)]
  if bend:
    ns.pitch_bends = [module.PitchBend(time=0.2, bend=300)]
  return ns


@pytest.mark.parametrize('bend', (False, True))
def test_tokenize_multitrack_example_matches_jax(bend):
  from mt3_tpu.codec import vocabulary as jax_vocabulary
  from mt3_tpu.core import config as jax_config
  from mt3_tpu.core import note_sequence as jax_ns
  from mt3_tpu_torch.codec import vocabulary
  from mt3_tpu_torch.core import note_sequence as port_ns
  audio = (np.random.RandomState(0).randn(16000) * 0.1).astype(np.float32)
  kwargs = dict(inst_names=['Acoustic Piano', 'Drums'],
                samples=audio, slakh_classes=True, is_training_data=True,
                ignore_pitch_bends=not bend)
  ours = program_maps.tokenize_multitrack_example(
      [_track(port_ns, 60, bend=bend), _track(port_ns, 38)],
      spectrogram_config=SpectrogramConfig(),
      codec=vocabulary.build_codec(VocabularyConfig()), **kwargs)
  theirs = jax_program_maps.tokenize_multitrack_example(
      [_track(jax_ns, 60, bend=bend), _track(jax_ns, 38)],
      spectrogram_config=jax_config.SpectrogramConfig(),
      codec=jax_vocabulary.build_codec(jax_config.VocabularyConfig()),
      **kwargs)
  if bend:
    assert ours is None and theirs is None
    return
  assert _notes(ours['sequence']) == _notes(theirs['sequence'])
  for key in ('inputs', 'targets', 'input_event_start_indices',
              'input_event_end_indices', 'state_events',
              'input_state_event_indices'):
    np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


# ---------------------------------------------------------------------------
# The polyphonic synth
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('seed', (1000, 1001, 9_001_000))
def test_compose_and_render_identical(seed):
  ours = synth.compose_example(seed, 2.5, max_instruments=4, drum_prob=0.7)
  theirs = jax_synth.compose_example(seed, 2.5, max_instruments=4,
                                     drum_prob=0.7)
  assert ours.id == theirs.id and _notes(ours) == _notes(theirs)
  audio = synth.render_note_sequence(ours, 2.5, seed=seed)
  want = jax_synth.render_note_sequence(theirs, 2.5, seed=seed)
  assert audio.dtype == want.dtype == np.float32
  np.testing.assert_array_equal(audio, want)


def test_polysynth_source_identical():
  ours = datasets.resolve_data_source('polysynth:3:1000')
  theirs = jax_datasets.resolve_data_source('polysynth:3:1000')
  ours.duration = theirs.duration = 2.0
  _assert_examples_equal(list(ours.examples()), list(theirs.examples()))


# ---------------------------------------------------------------------------
# Reference-schema TFRecords (fixtures of tests/test_noteseq_proto.py)
# ---------------------------------------------------------------------------
def _wav_bytes(samples, rate):
  buf = io.BytesIO()
  with wave.open(buf, 'wb') as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(rate)
    w.writeframes((np.clip(samples, -1, 1) * 32767).astype('<i2').tobytes())
  return buf.getvalue()


def _proto(*notes, bends=()):
  ns = NoteSequence(total_time=2.0, ticks_per_quarter=220)
  ns.notes = [Note(pitch=p, velocity=v, start_time=s, end_time=e)
              for p, v, s, e in notes]
  ns.pitch_bends = [PitchBend(time=t, bend=b) for t, b in bends]
  return noteseq_proto.notesequence_to_bytes(ns)


_NS = _proto((60, 80, 0.10, 0.55), (64, 90, 0.50, 1.20), (67, 70, 1.0, 1.9))


def _audio(seed, n):
  return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


def _schema_records(name):
  """(dataset, [records]) for one fixture."""
  if name == 'maestro':
    return 'maestrov3', [tfrecord.make_example({
        'audio': _wav_bytes(_audio(0, 32000), 16000), 'sequence': _NS,
        'id': b'maestro-ex'})]
  if name == 'maestro_48k':
    return 'maestrov1', [tfrecord.make_example({
        'audio': _wav_bytes(_audio(1, 48000), 48000), 'sequence': _NS,
        'id': b'hi-rate'})]
  if name == 'musicnet':
    return 'musicnet', [tfrecord.make_example({
        'id': b'musicnet-2303', 'sample_rate': np.array([44100.0], np.float32),
        'audio': _audio(2, 44100), 'sequence': _NS})]
  if name == 'guitarset':
    return 'guitarset', [tfrecord.make_example({
        'audio': _wav_bytes(_audio(3, 16000), 16000),
        'sequence': _proto((52, 95, 0.1, 0.9), (52, 90, 0.5, 1.2)),
        'velocity_range': b'', 'id': b'gset-1'})]
  if name == 'urmp':
    vn, vc = _proto((76, 90, 0.1, 0.9)), _proto((48, 85, 0.2, 1.0))
    return 'urmp', [tfrecord.make_example({
        'id': b'urmp-01', 'audio': _wav_bytes(_audio(4, 16000), 16000),
        'sequence': vn, 'instrument_sequences': [vn, vc],
        'inst_names': [b'vn', b'vc'], 'tracks': np.array([0, 1], np.int64)})]
  if name == 'slakh':
    return 'slakh', [tfrecord.make_example({
        'mix': _audio(5, 22050),
        'audio_sample_rate': np.array([22050], np.int64),
        'note_sequences': [_proto((60, 100, 0.0, 0.5), (60, 90, 0.3, 0.9)),
                           _proto((38, 110, 0.25, 0.26)),
                           _proto((40, 70, 0.1, 0.6), bends=((0.2, 100),))],
        'inst_names': [b'Acoustic Piano', b'Drums', b'Electric Bass'],
        'track_id': b'Track00001'})]
  if name == 'cerberus4':
    return 'cerberus4', [tfrecord.make_example({
        'mix': _audio(6, 8000),
        'audio_sample_rate': np.array([16000], np.int64),
        'note_sequences': [_proto((p, 90, 0.0, 0.5)) for p in (36, 38, 52, 60)],
        'inst_names': [b'bass', b'drums', b'guitar', b'piano'],
        'track_id': b'cerb-1'})]
  raise KeyError(name)


SCHEMAS = ('maestro', 'maestro_48k', 'musicnet', 'guitarset', 'urmp',
           'slakh', 'cerberus4')


@pytest.mark.parametrize('is_training', (False, True))
@pytest.mark.parametrize('ignore_pitch_bends', (True, False))
@pytest.mark.parametrize('name', SCHEMAS)
def test_reference_schemas_identical(tmp_path, name, ignore_pitch_bends,
                                     is_training):
  dataset, records = _schema_records(name)
  path = str(tmp_path / f'{name}.tfrecord')
  tfrecord.write_records(path, records)
  ours = datasets.ReferenceTFRecordDataSource(
      datasets.ALL_DATASET_CONFIGS[dataset], path, SpectrogramConfig(),
      is_training=is_training, ignore_pitch_bends=ignore_pitch_bends)
  theirs = jax_datasets.ReferenceTFRecordDataSource(
      jax_datasets.ALL_DATASET_CONFIGS[dataset], path,
      jax_datasets.SpectrogramConfig(), is_training=is_training,
      ignore_pitch_bends=ignore_pitch_bends)
  assert len(ours) == len(theirs) == 1
  got, want = list(ours.examples()), list(theirs.examples())
  if name == 'slakh' and not ignore_pitch_bends:
    assert got == want == []   # the bass track bends: the example is skipped
    return
  _assert_examples_equal(got, want)


def test_shard_globs_identical(tmp_path):
  for i in range(3):
    tfrecord.write_records(
        str(tmp_path / f'data.tfrecord-{i:05d}-of-00003'),
        [tfrecord.make_example({
            'audio': _wav_bytes(_audio(10 + i, 8000), 16000),
            'sequence': _NS, 'id': f'shard-{i}'.encode()})])
  spec = str(tmp_path / 'data.tfrecord-?????-of-00003')
  ours = datasets.resolve_data_source(spec, dataset='maestrov3')
  theirs = jax_datasets.resolve_data_source(spec, dataset='maestrov3')
  assert ours.paths == theirs.paths and len(ours.paths) == 3
  _assert_examples_equal(list(ours.examples()), list(theirs.examples()))
  with pytest.raises(FileNotFoundError):
    datasets.resolve_data_source(str(tmp_path / 'none.tfrecord-?????'))


def test_our_schema_tfrecord_source_identical(tmp_path):
  """TFRecordDataSource: float audio + a Standard MIDI File, the schema
  the monophonic extraction script writes."""
  ns = NoteSequence(total_time=1.0)
  ns.notes = [Note(pitch=62, velocity=100, start_time=0.0, end_time=0.5)]
  path = str(tmp_path / 'ours.tfrecord')
  tfrecord.write_records(path, [tfrecord.make_example({
      'audio': _audio(7, 16000),
      'sequence': [midi_io.note_sequence_to_midi(ns)], 'id': [b'mono-0']})])
  ours = datasets.TFRecordDataSource(path)
  theirs = jax_datasets.TFRecordDataSource(path)
  assert len(ours) == len(theirs) == 1
  _assert_examples_equal(list(ours.examples()), list(theirs.examples()))


# ---------------------------------------------------------------------------
# Local sources and the mixture
# ---------------------------------------------------------------------------
def _write_pair(directory, stem, seed, midi_ext='.mid', rate=16000):
  ns = synth.compose_example(seed, 1.5, max_instruments=2)
  audio = synth.render_note_sequence(ns, 1.5, sample_rate=rate, seed=seed)
  (directory / f'{stem}.wav').write_bytes(_wav_bytes(audio, rate))
  midi_io.note_sequence_to_midi_file(ns, str(directory / f'{stem}{midi_ext}'))


def test_local_pairs_identical(tmp_path):
  _write_pair(tmp_path, 'b', 1, '.midi')
  _write_pair(tmp_path, 'a', 2, '.mid', rate=22050)
  (tmp_path / 'orphan.wav').write_bytes(_wav_bytes(_audio(0, 800), 16000))
  ours = datasets.resolve_data_source(str(tmp_path))
  theirs = jax_datasets.resolve_data_source(str(tmp_path))
  assert type(ours).__name__ == 'LocalPairsDataSource'
  assert ours.pairs == theirs.pairs and len(ours) == 2
  _assert_examples_equal(list(ours.examples()), list(theirs.examples()))


@pytest.mark.parametrize('version', ('v1', 'v3'))
@pytest.mark.parametrize('split', ('train', 'validation'))
def test_maestro_metadata_identical(tmp_path, version, split):
  rows = []
  for i, row_split in enumerate(('train', 'validation', 'train', 'test')):
    (tmp_path / '2018').mkdir(exist_ok=True)
    _write_pair(tmp_path / '2018', f'piece-{i}', 20 + i, '.midi')
    rows.append({'split': row_split, 'audio_filename': f'2018/piece-{i}.wav',
                 'midi_filename': f'2018/piece-{i}.midi'})
  if version == 'v1':
    meta = rows
  else:
    meta = {key: {str(i): row[key] for i, row in enumerate(rows)}
            for key in rows[0]}
  (tmp_path / f'maestro-{version}.0.0.json').write_text(json.dumps(meta))
  ours = datasets.MaestroDataSource(str(tmp_path), split)
  theirs = jax_datasets.MaestroDataSource(str(tmp_path), split)
  assert ours.records == theirs.records
  assert len(ours) == {'train': 2, 'validation': 1}[split]
  _assert_examples_equal(list(ours.examples()), list(theirs.examples()))


def test_maestro_without_metadata_raises(tmp_path):
  with pytest.raises(FileNotFoundError):
    datasets.MaestroDataSource(str(tmp_path))


@pytest.mark.parametrize('seed', (0, 7))
def test_mixture_draws_like_jax(seed):
  sizes = (1, 2, 5)

  def sources(module):
    return [module.SyntheticDataSource(num_examples=n, duration=1.0,
                                       seed=100 * i)
            for i, n in enumerate(sizes)]

  ours = datasets.MixtureSource(sources(datasets), seed=seed)
  theirs = jax_datasets.MixtureSource(sources(jax_datasets), seed=seed)
  np.testing.assert_array_equal(ours.probs, theirs.probs)
  assert len(ours) == len(theirs) == sum(sizes)
  got, want = ours.examples(), theirs.examples()
  drawn = [next(got) for _ in range(12)]
  _assert_examples_equal(drawn, [next(want) for _ in range(12)])
  # Every source was drawn, and exhausted ones restarted.
  assert len({ex['sequence'].id for ex in drawn}) > 3


def test_wav_bytes_to_samples_identical():
  data = _wav_bytes(_audio(9, 4410), 44100)
  np.testing.assert_array_equal(
      datasets.wav_bytes_to_samples(data, 16000),
      jax_datasets.wav_bytes_to_samples(data, 16000))


# ---------------------------------------------------------------------------
# The scripts
# ---------------------------------------------------------------------------
def test_dump_task_prints_like_jax(tmp_path, capsys):
  dataset, records = _schema_records('slakh')
  path = str(tmp_path / 'slakh.tfrecord')
  tfrecord.write_records(path, records)
  argv = ['--model', 'tiny', '--data', path, '--dataset', dataset,
          '--num_examples', '2', '--decode_targets']
  dump_task.main(argv)
  ours = capsys.readouterr().out
  jax_dump_task.main(argv)
  assert ours == capsys.readouterr().out
  assert 'decoded:' in ours and 'EOS' in ours


def test_extract_monophonic_writes_like_jax(tmp_path):
  t = np.arange(5 * 16000) / 16000
  tone = 0.5 * np.sin(2 * np.pi * np.where(t < 2.5, 261.63, 329.63) * t)
  (tmp_path / 'tone.wav').write_bytes(_wav_bytes(tone, 16000))
  for module, out in ((mono, 'ours'), (jax_mono, 'theirs')):
    module.main([str(tmp_path / 'tone.wav'), '--output',
                 str(tmp_path / f'{out}.tfrecord')])
  ours = (tmp_path / 'ours.tfrecord').read_bytes()
  assert ours == (tmp_path / 'theirs.tfrecord').read_bytes()
  (example,) = datasets.TFRecordDataSource(
      str(tmp_path / 'ours.tfrecord')).examples()
  assert {60, 64} <= {n.pitch for n in example['sequence'].notes}
