"""Dataset registry: corpora configs, adapters, mixtures (copy of mt3_tpu/data/datasets.py).

Rebuild of mt3/datasets.py (8 corpora configs) and the
task/mixture registry in tasks.py:241-402, without seqio/tf.data.

The reference reads GCS TFRecords of serialized NoteSequence protos +
audio.  This environment has no data egress, so the registry carries the
corpus *metadata* (name, splits, track specs, program-lookup behavior)
plus local-filesystem adapters:

  * LocalPairsDataSource: directories of (audio.wav, *.mid) pairs — the
    natural local layout for MAESTRO-style corpora.
  * SyntheticDataSource: procedurally generated note sequences + rendered
    audio, used by tests and benchmarks and as a training smoke corpus.

Temperature-based mixture sampling (seqio.mixing_rate_num_examples with
temperature 10/3, tasks.py:377-402) is reimplemented in `MixtureSource`.
"""

from __future__ import annotations

import dataclasses
import os
import wave
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from mt3_tpu_torch.codec.note_events import TrackSpec
from mt3_tpu_torch.core import midi_io
from mt3_tpu_torch.core.config import SpectrogramConfig
from mt3_tpu_torch.core.note_sequence import NoteSequence

MIXING_TEMPERATURE = 10 / 3


def construct_task_name(task_prefix: str,
                        spectrogram_config: SpectrogramConfig =
                        SpectrogramConfig(),
                        vocab_config=None,
                        task_suffix: Optional[str] = None) -> str:
  """Abbreviation-aware task name (reference tasks.py:41-55)."""
  from mt3_tpu_torch.core.config import VocabularyConfig
  vocab_config = vocab_config or VocabularyConfig()
  fields = [task_prefix]
  if spectrogram_config.abbrev_str:
    fields.append(spectrogram_config.abbrev_str)
  if vocab_config.abbrev_str:
    fields.append(vocab_config.abbrev_str)
  if task_suffix:
    fields.append(task_suffix)
  return '_'.join(fields)


@dataclasses.dataclass
class InferEvalSplit:
  name: str
  suffix: str
  include_in_mixture: bool = True


@dataclasses.dataclass
class DatasetConfig:
  """Transcription corpus metadata (reference datasets.py:35-53)."""
  name: str
  train_split: str
  train_eval_split: str
  infer_eval_splits: Sequence[InferEvalSplit]
  track_specs: Sequence[TrackSpec] = dataclasses.field(default_factory=list)
  # Reference TFRecord feature-schema family (see
  # ReferenceTFRecordDataSource): 'wav_proto' (MAESTRO/GuitarSet),
  # 'samples_proto' (MusicNet), 'wav_tracks' (URMP), 'mix_tracks'
  # (Slakh/Cerberus4).
  schema: str = 'wav_proto'
  # Notes on the reference's source data, for provenance.
  notes: str = ''


# The eight corpora the reference registers (datasets.py:55-323).
MAESTROV1_CONFIG = DatasetConfig(
    name='maestrov1', train_split='train', train_eval_split='validation',
    infer_eval_splits=[
        InferEvalSplit('train', 'eval_train', include_in_mixture=False),
        InferEvalSplit('validation', 'validation'),
        InferEvalSplit('test', 'test', include_in_mixture=False)],
    notes='MAESTRO v1.0.0 piano; gs://magentadata TFRecords in reference')

MAESTROV3_CONFIG = DatasetConfig(
    name='maestrov3', train_split='train', train_eval_split='validation',
    infer_eval_splits=[
        InferEvalSplit('train', 'eval_train', include_in_mixture=False),
        InferEvalSplit('validation', 'validation'),
        InferEvalSplit('test', 'test', include_in_mixture=False)],
    notes='MAESTRO v3.0.0 piano')

GUITARSET_CONFIG = DatasetConfig(
    name='guitarset', schema='wav_tracks', train_split='train',
    train_eval_split='validation',
    infer_eval_splits=[
        InferEvalSplit('train', 'eval_train', include_in_mixture=False),
        InferEvalSplit('validation', 'validation')],
    notes='GuitarSet acoustic guitar (program 24 via lookup)')

URMP_CONFIG = DatasetConfig(
    name='urmp', schema='wav_tracks', train_split='train', train_eval_split='train',
    infer_eval_splits=[
        InferEvalSplit('train', 'eval_train', include_in_mixture=False),
        InferEvalSplit('test', 'test')],
    notes='URMP multi-instrument; per-instrument program lookup')

MUSICNET_CONFIG = DatasetConfig(
    name='musicnet', schema='samples_proto', train_split='train', train_eval_split='validation',
    infer_eval_splits=[
        InferEvalSplit('train', 'eval_train', include_in_mixture=False),
        InferEvalSplit('validation', 'validation'),
        InferEvalSplit('test', 'test', include_in_mixture=False)],
    notes='MusicNet classical recordings')

MUSICNET_EM_CONFIG = DatasetConfig(
    name='musicnet_em', schema='samples_proto', train_split='train', train_eval_split='validation',
    infer_eval_splits=[
        InferEvalSplit('train', 'eval_train', include_in_mixture=False),
        InferEvalSplit('validation', 'validation'),
        InferEvalSplit('test', 'test', include_in_mixture=False)],
    notes='MusicNet with EM-refined labels')

CERBERUS4_CONFIG = DatasetConfig(
    name='cerberus4', schema='mix_tracks', train_split='train',
    train_eval_split='validation',
    infer_eval_splits=[
        InferEvalSplit('train', 'eval_train', include_in_mixture=False),
        InferEvalSplit('validation', 'validation')],
    track_specs=[
        TrackSpec('bass', program=32),
        TrackSpec('drums', is_drum=True),
        TrackSpec('guitar', program=24),
        TrackSpec('piano', program=0)],
    notes='Slakh bass/drums/guitar/piano subsets mixed')

SLAKH_CONFIG = DatasetConfig(
    name='slakh', schema='mix_tracks', train_split='train', train_eval_split='validation',
    infer_eval_splits=[
        InferEvalSplit('train', 'eval_train', include_in_mixture=False),
        InferEvalSplit('validation', 'validation'),
        InferEvalSplit('test', 'test', include_in_mixture=False)],
    notes='Slakh2100 multi-track synthetic mixes')

ALL_DATASET_CONFIGS = {
    cfg.name: cfg for cfg in [
        MAESTROV1_CONFIG, MAESTROV3_CONFIG, GUITARSET_CONFIG, URMP_CONFIG,
        MUSICNET_CONFIG, MUSICNET_EM_CONFIG, CERBERUS4_CONFIG, SLAKH_CONFIG]
}

# Datasets included in the mega mixture (tasks.py:362-365).
MIXTURE_DATASET_NAMES = (
    'maestrov3', 'guitarset', 'urmp', 'musicnet_em', 'cerberus4', 'slakh')


# ---------------------------------------------------------------------------
# Data sources
# ---------------------------------------------------------------------------
class DataSource:
  """Iterable of {'sequence': NoteSequence, 'audio': float32 samples}."""

  def __len__(self) -> int:
    raise NotImplementedError

  def examples(self) -> Iterator[Dict]:
    raise NotImplementedError


def wav_bytes_to_samples(data: bytes, expected_rate: int) -> np.ndarray:
  """Decode an in-memory WAV file (reference corpora store WAV bytes)."""
  import io
  return read_wav(io.BytesIO(data), expected_rate)


def resample_audio(samples: np.ndarray, rate: int,
                   expected_rate: int) -> np.ndarray:
  """Polyphase resample (host side; replaces librosa.resample)."""
  if rate == expected_rate:
    return samples.astype(np.float32)
  from math import gcd
  from scipy.signal import resample_poly
  g = gcd(int(rate), int(expected_rate))
  return resample_poly(samples, expected_rate // g,
                       rate // g).astype(np.float32)


def read_wav(path, expected_rate: int) -> np.ndarray:
  """Minimal WAV reader (PCM16/PCM32/float32), mono-mixed, resampled.

  `path` may be a filename or a binary file object.
  """
  with wave.open(path, 'rb') as w:
    rate = w.getframerate()
    n = w.getnframes()
    width = w.getsampwidth()
    channels = w.getnchannels()
    raw = w.readframes(n)
  if width == 2:
    samples = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
  elif width == 4:
    samples = np.frombuffer(raw, np.int32).astype(np.float32) / 2**31
  else:
    raise ValueError(f'unsupported sample width: {width}')
  if channels > 1:
    samples = samples.reshape(-1, channels).mean(axis=1)
  return resample_audio(samples, rate, expected_rate)


class LocalPairsDataSource(DataSource):
  """Directory of (x.wav, x.mid|x.midi) pairs, MAESTRO-style."""

  def __init__(self, directory: str,
               spectrogram_config: SpectrogramConfig = SpectrogramConfig()):
    self.directory = directory
    self.sample_rate = spectrogram_config.sample_rate
    self.pairs: List[tuple] = []
    for name in sorted(os.listdir(directory)):
      if not name.endswith('.wav'):
        continue
      stem = name[:-4]
      for ext in ('.mid', '.midi'):
        midi_path = os.path.join(directory, stem + ext)
        if os.path.exists(midi_path):
          self.pairs.append((os.path.join(directory, name), midi_path))
          break

  def __len__(self):
    return len(self.pairs)

  def examples(self):
    for wav_path, midi_path in self.pairs:
      ns = midi_io.midi_file_to_note_sequence(midi_path)
      ns.id = os.path.basename(wav_path)
      audio = read_wav(wav_path, self.sample_rate)
      yield {'sequence': ns, 'audio': audio}


class MaestroDataSource(DataSource):
  """MAESTRO on local disk, using the official metadata JSON for splits.

  Expects the standard layout: root/maestro-vX.0.0.json plus the
  audio/midi files it references.  Handles both the row-oriented (v1/v2)
  and column-oriented (v3) JSON formats.
  """

  def __init__(self, root: str, split: str = 'train',
               spectrogram_config: SpectrogramConfig = SpectrogramConfig()):
    import glob
    import json
    self.root = root
    self.sample_rate = spectrogram_config.sample_rate
    meta_paths = sorted(glob.glob(os.path.join(root, 'maestro-v*.json')))
    if not meta_paths:
      raise FileNotFoundError(f'no maestro-v*.json under {root}')
    with open(meta_paths[-1]) as f:
      meta = json.load(f)

    records = []
    if isinstance(meta, list):  # v1/v2: list of row dicts
      for row in meta:
        records.append((row['split'], row['audio_filename'],
                        row['midi_filename']))
    else:  # v3: column-oriented dict of {index: value}
      keys = sorted(meta['split'].keys(), key=lambda k: int(k))
      for k in keys:
        records.append((meta['split'][k], meta['audio_filename'][k],
                        meta['midi_filename'][k]))
    self.records = [(a, m) for s, a, m in records if s == split]

  def __len__(self):
    return len(self.records)

  def examples(self):
    for audio_rel, midi_rel in self.records:
      ns = midi_io.midi_file_to_note_sequence(
          os.path.join(self.root, midi_rel))
      ns.id = audio_rel
      audio = read_wav(os.path.join(self.root, audio_rel),
                       self.sample_rate)
      yield {'sequence': ns, 'audio': audio}


class SyntheticDataSource(DataSource):
  """Procedural music: random note sequences + additive-sine rendering."""

  def __init__(self, num_examples: int = 8, duration: float = 4.0,
               sample_rate: int = 16000, seed: int = 0,
               polyphony: int = 3, include_drums: bool = False,
               programs: Sequence[int] = (0,)):
    self.num_examples = num_examples
    self.duration = duration
    self.sample_rate = sample_rate
    self.seed = seed
    self.polyphony = polyphony
    self.include_drums = include_drums
    self.programs = programs

  def __len__(self):
    return self.num_examples

  def _render(self, ns: NoteSequence) -> np.ndarray:
    n = int(self.duration * self.sample_rate)
    audio = np.zeros(n, np.float32)
    t = np.arange(n) / self.sample_rate
    for note in ns.notes:
      if note.is_drum:
        i0, i1 = int(note.start_time * self.sample_rate), int(
            (note.start_time + 0.05) * self.sample_rate)
        rng = np.random.RandomState(note.pitch)
        burst = rng.randn(max(i1 - i0, 1)).astype(np.float32)
        audio[i0:i0 + len(burst)] += 0.3 * burst * (
            note.velocity / 127.0)
        continue
      freq = 440.0 * 2 ** ((note.pitch - 69) / 12.0)
      mask = (t >= note.start_time) & (t < note.end_time)
      seg = t[mask]
      env = np.minimum(1.0, (seg - note.start_time) * 100)
      env *= np.exp(-(seg - note.start_time) * 2.0)
      audio[mask] += (note.velocity / 127.0) * env * np.sin(
          2 * np.pi * freq * seg).astype(np.float32)
    peak = np.max(np.abs(audio))
    return audio / peak if peak > 0 else audio

  def examples(self):
    for i in range(self.num_examples):
      rng = np.random.RandomState(self.seed + i)
      ns = NoteSequence()
      ns.id = f'synthetic-{i}'
      time = 0.1
      while time < self.duration - 0.3:
        for _ in range(rng.randint(1, self.polyphony + 1)):
          pitch = int(rng.randint(48, 84))
          dur = float(rng.uniform(0.1, 0.8))
          program = int(self.programs[rng.randint(len(self.programs))])
          ns.add_note(pitch=pitch, velocity=int(rng.randint(32, 127)),
                      start_time=round(time, 3),
                      end_time=round(min(time + dur, self.duration), 3),
                      program=program)
        if self.include_drums and rng.rand() < 0.5:
          ns.add_note(pitch=int(rng.choice([36, 38, 42])),
                      velocity=int(rng.randint(64, 127)),
                      start_time=round(time, 3),
                      end_time=round(time + 0.01, 3), is_drum=True)
        time += float(rng.uniform(0.2, 0.6))
      ns.total_time = self.duration
      yield {'sequence': ns, 'audio': self._render(ns)}


class TFRecordDataSource(DataSource):
  """TFRecords of tf.train.Example with our schema.

  Features: 'audio' (float list, 16 kHz samples), 'sequence' (bytes:
  a Standard MIDI File), optional 'id' (bytes).  Read through the native
  C++ record reader (mt3_tpu/data/tfrecord.py).  The monophonic
  extraction script writes this schema.
  """

  def __init__(self, paths, spectrogram_config=SpectrogramConfig()):
    if isinstance(paths, str):
      paths = [paths]
    self.paths = list(paths)
    self.sample_rate = spectrogram_config.sample_rate
    self._len = None

  def __len__(self):
    if self._len is None:
      from mt3_tpu_torch.data import tfrecord
      self._len = sum(
          sum(1 for _ in tfrecord.read_records(p)) for p in self.paths)
    return self._len

  def examples(self):
    from mt3_tpu_torch.core import midi_io
    from mt3_tpu_torch.data import tfrecord
    for path in self.paths:
      for features in tfrecord.read_examples(path):
        ns = midi_io.midi_to_note_sequence(bytes(features['sequence'][0]))
        if 'id' in features:
          ns.id = features['id'][0].decode()
        audio = np.asarray(features['audio'], np.float32)
        yield {'sequence': ns, 'audio': audio}


def resolve_data_source(spec: str,
                        spectrogram_config=SpectrogramConfig(),
                        dataset: str = 'maestrov3',
                        is_training: bool = False,
                        num_examples: Optional[int] = None,
                        seed: int = 0) -> DataSource:
  """Map a CLI --data spec to a DataSource.

  'synthetic' -> procedural corpus; '*.tfrecord' (comma-separable) ->
  ReferenceTFRecordDataSource with the named corpus schema; otherwise a
  directory of (wav, mid) pairs.
  """
  if spec == 'synthetic':
    return SyntheticDataSource(num_examples=num_examples or 4,
                               duration=4.0,
                               sample_rate=spectrogram_config.sample_rate,
                               seed=seed)
  if spec.startswith('polysynth'):
    # 'polysynth[:N[:seed]]' — polyphonic multi-program procedural corpus.
    from mt3_tpu_torch.data.synth import PolyphonicSynthDataSource
    parts = spec.split(':')
    n = int(parts[1]) if len(parts) > 1 else (num_examples or 64)
    s = int(parts[2]) if len(parts) > 2 else seed
    return PolyphonicSynthDataSource(
        num_examples=n, seed=s, max_instruments=4,
        sample_rate=spectrogram_config.sample_rate)
  if spec.endswith('.tfrecord') or '.tfrecord-' in spec:
    return ReferenceTFRecordDataSource(
        ALL_DATASET_CONFIGS[dataset], spec.split(','),
        spectrogram_config, is_training=is_training)
  return LocalPairsDataSource(spec, spectrogram_config)


class PitchBendError(Exception):
  """Raised when a track has pitch bends we cannot represent."""


def _merge_track(ns: NoteSequence, track: NoteSequence, program: int,
                 is_drum: bool, ignore_pitch_bends: bool) -> None:
  """Merge one instrument track into `ns` with an assigned program.

  Sustain pedal is resolved per track before merging; pitch bends are an
  error unless ignored (reference preprocessors.py:470-486).
  """
  from mt3_tpu_torch.core import sustain
  if track.pitch_bends and not ignore_pitch_bends:
    raise PitchBendError()
  track = sustain.apply_sustain_control_changes(track)
  for note in track.notes:
    note.program = program
    note.is_drum = is_drum
    ns.notes.append(note)
    ns.total_time = max(ns.total_time, note.end_time)


class ReferenceTFRecordDataSource(DataSource):
  """Reads the reference corpora's actual TFRecord schemas.

  The reference datasets (mt3/datasets.py:55-323) are
  TFRecords of tf.train.Example whose 'sequence'/'note_sequences'
  features hold serialized NoteSequence protos.  Schema families:

    * 'wav_proto'     audio=WAV bytes, sequence=proto, id
                      (MAESTRO v1/v3)
    * 'samples_proto' audio=float samples, sample_rate, sequence=proto,
                      id (MusicNet, MusicNetEM)
    * 'wav_tracks'    audio=WAV bytes, instrument_sequences=[proto...],
                      inst_names, id (URMP; GuitarSet via its single
                      'sequence' + constant 'Clean Guitar' name)
    * 'mix_tracks'    mix=float samples, audio_sample_rate,
                      note_sequences=[proto...], inst_names, track_id
                      (Slakh2100, Cerberus4)

  Program numbers for track schemas come from the corpus lookup
  (program_maps) or the config's track_specs (Cerberus4).
  """

  def __init__(self, config: DatasetConfig, paths,
               spectrogram_config=SpectrogramConfig(),
               is_training: bool = False,
               ignore_pitch_bends: bool = True):
    import glob as glob_lib
    if isinstance(paths, str):
      paths = [paths]
    expanded = []
    for path in paths:
      # Reference shard patterns ('...tfrecord-?????-of-00025').
      if any(c in path for c in '*?['):
        matches = sorted(glob_lib.glob(path))
        if not matches:
          raise FileNotFoundError(f'no files match {path}')
        expanded.extend(matches)
      else:
        expanded.append(path)
    self.config = config
    self.paths = expanded
    self.spectrogram_config = spectrogram_config
    self.sample_rate = spectrogram_config.sample_rate
    self.is_training = is_training
    self.ignore_pitch_bends = ignore_pitch_bends
    self._len = None

  def __len__(self):
    """Record count across shards.

    An upper bound on len(list(examples())): tracks with pitch bends
    are skipped at iteration time when ignore_pitch_bends=False
    (counting them up front would require a full parse pass).
    """
    if self._len is None:
      from mt3_tpu_torch.data import tfrecord
      self._len = sum(
          sum(1 for _ in tfrecord.read_records(p)) for p in self.paths)
    return self._len

  def _program_for(self, inst_name: str):
    from mt3_tpu_torch.data import program_maps
    name = self.config.name
    if name == 'guitarset':
      return program_maps.guitarset_instrument_to_program(inst_name), False
    if name == 'urmp':
      return program_maps.urmp_instrument_to_program(inst_name), False
    return program_maps.slakh_class_to_program_and_is_drum(inst_name)

  def _merge_tracks(self, protos, inst_names) -> Optional[NoteSequence]:
    from mt3_tpu_torch.codec import note_events
    from mt3_tpu_torch.core import noteseq_proto
    ns = NoteSequence(ticks_per_quarter=220)
    tracks = [noteseq_proto.notesequence_from_bytes(p) for p in protos]
    if len(tracks) != len(inst_names):
      raise ValueError('track/instrument count mismatch: %d vs %d' %
                       (len(tracks), len(inst_names)))
    try:
      if self.config.track_specs:
        if len(tracks) != len(self.config.track_specs):
          raise ValueError('expected %d tracks, got %d' %
                           (len(self.config.track_specs), len(tracks)))
        for track, spec, inst_name in zip(tracks, self.config.track_specs,
                                          inst_names):
          if inst_name != spec.name:
            raise ValueError('unexpected instrument: %s != %s' %
                             (inst_name, spec.name))
          _merge_track(ns, track, spec.program, spec.is_drum,
                       self.ignore_pitch_bends)
      else:
        for track, inst_name in zip(tracks, inst_names):
          program, is_drum = self._program_for(inst_name)
          _merge_track(ns, track, program, is_drum,
                       self.ignore_pitch_bends)
    except PitchBendError:
      return None  # skip examples with unrepresentable pitch bends
    note_events.assign_instruments(ns)
    note_events.validate_note_sequence(ns)
    if self.is_training:
      # The event vocabulary cannot represent overlapping same-pitch
      # notes; trim for training, keep intact for eval.
      ns = note_events.trim_overlapping_notes(ns)
    return ns

  def _decode_example(self, features) -> Optional[Dict]:
    from mt3_tpu_torch.core import noteseq_proto
    schema = self.config.schema
    if schema == 'wav_proto':
      ns = noteseq_proto.notesequence_from_bytes(
          bytes(features['sequence'][0]))
      audio = wav_bytes_to_samples(bytes(features['audio'][0]),
                                   self.sample_rate)
    elif schema == 'samples_proto':
      ns = noteseq_proto.notesequence_from_bytes(
          bytes(features['sequence'][0]))
      rate = int(np.asarray(features['sample_rate']).reshape(-1)[0])
      audio = resample_audio(np.asarray(features['audio'], np.float32),
                             rate, self.sample_rate)
    elif schema == 'wav_tracks':
      if 'instrument_sequences' in features:
        protos = [bytes(p) for p in features['instrument_sequences']]
        names = [n.decode() for n in features['inst_names']]
      else:
        # GuitarSet: single 'sequence' + constant instrument
        # (reference preprocessors.py:229-253).
        protos = [bytes(features['sequence'][0])]
        names = ['Clean Guitar']
      ns = self._merge_tracks(protos, names)
      audio = wav_bytes_to_samples(bytes(features['audio'][0]),
                                   self.sample_rate)
    elif schema == 'mix_tracks':
      protos = [bytes(p) for p in features['note_sequences']]
      names = [n.decode() for n in features['inst_names']]
      ns = self._merge_tracks(protos, names)
      rate = int(np.asarray(features['audio_sample_rate']).reshape(-1)[0])
      audio = resample_audio(np.asarray(features['mix'], np.float32),
                             rate, self.sample_rate)
    else:
      raise ValueError(f'unknown schema: {schema}')
    if ns is None:
      return None
    for id_key in ('id', 'track_id'):
      if id_key in features and not ns.id:
        ns.id = features[id_key][0].decode()
    return {'sequence': ns, 'audio': audio}

  def examples(self):
    from mt3_tpu_torch.data import tfrecord
    for path in self.paths:
      for features in tfrecord.read_examples(path):
        example = self._decode_example(features)
        if example is not None:
          yield example


class MixtureSource(DataSource):
  """Temperature-weighted mixture over sources (tasks.py:377-402).

  Sampling rate for source i is proportional to len(i)^(1/T) with
  T = MIXING_TEMPERATURE, the seqio mixing_rate_num_examples semantics.
  """

  def __init__(self, sources: Sequence[DataSource],
               temperature: float = MIXING_TEMPERATURE, seed: int = 0):
    self.sources = list(sources)
    sizes = np.array([max(len(s), 1) for s in self.sources], np.float64)
    rates = sizes ** (1.0 / temperature)
    self.probs = rates / rates.sum()
    self.seed = seed

  def __len__(self):
    return sum(len(s) for s in self.sources)

  def examples(self):
    rng = np.random.RandomState(self.seed)
    iterators = [None] * len(self.sources)
    while True:
      i = int(rng.choice(len(self.sources), p=self.probs))
      if iterators[i] is None:
        iterators[i] = self.sources[i].examples()
      try:
        yield next(iterators[i])
      except StopIteration:
        iterators[i] = self.sources[i].examples()
        yield next(iterators[i])
