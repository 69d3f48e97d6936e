"""The port's TFRecord and NoteSequence wire formats against mt3_tpu.

* mt3_tpu_torch.data.tfrecord is the JAX package's module but for its
  loader, which compiles native/tfrecord.cc at first use: every other
  function is pinned to its original, and noteseq_proto is a whole copy.
* Records written by either package read back equal through the other,
  and through both of the port's readers (native and Python).  A flipped
  byte raises IOError in every reader.
* notesequence_to_bytes is byte-identical to the JAX package's; the port's
  native and Python NoteSequence parsers agree field for field.
* The native library is built once into a directory keyed by the source's
  hash (concurrent builds included); without a compiler the Python reader
  runs and native_status() says so; a compiler that fails raises.

The JAX package's side reads through its own loader: its Python reader
unless native/libmt3_native.so has been built with `make -C native`.
"""

import dataclasses
import inspect
import re
import threading

import numpy as np
import pytest

from mt3_tpu.core import noteseq_proto as jax_noteseq_proto
from mt3_tpu.core import note_sequence as jax_note_sequence
from mt3_tpu.data import tfrecord as jax_tfrecord
from mt3_tpu_torch.core import note_sequence, noteseq_proto
from mt3_tpu_torch.data import tfrecord

_REFERENCE_CHECKOUT = re.compile(r'/[^\s:()]*/reference/mt3/')

TFRECORD_COPIES = (
    'native_available', 'read_records', '_masked_crc', '_crc32c',
    '_read_records_py', 'parse_example', 'read_examples', '_read_varint',
    '_iter_fields', '_parse_example_py', '_varint', '_field',
    '_length_delimited', 'make_example', 'write_records')


def _rewritten(source):
  return _REFERENCE_CHECKOUT.sub(
      'mt3/', source.replace('mt3_tpu.', 'mt3_tpu_torch.'))


@pytest.mark.parametrize('name', TFRECORD_COPIES)
def test_tfrecord_functions_are_pinned(name):
  assert inspect.getsource(getattr(tfrecord, name)) == _rewritten(
      inspect.getsource(getattr(jax_tfrecord, name)))


def test_noteseq_proto_is_pinned():
  mine = inspect.getsource(noteseq_proto).splitlines()
  orig = _rewritten(inspect.getsource(jax_noteseq_proto)).splitlines()
  assert mine[1:] == orig[1:]
  assert mine[0].startswith(orig[0].rstrip('.'))


def _features(seed):
  rng = np.random.RandomState(seed)
  return {
      'audio': rng.randn(int(rng.randint(1, 3000))).astype(np.float32),
      'ints': rng.randint(-2**40, 2**40, size=7).astype(np.int64),
      'rate': np.array([16000], np.int64),
      'bytes': [bytes(rng.randint(0, 256, size=n).astype(np.uint8))
                for n in (0, 5, 300)],
      'id': f'record-{seed}'.encode(),
  }


def _assert_features_equal(got, want):
  assert sorted(got) == sorted(want)
  for key in want:
    if isinstance(want[key], list):
      assert [bytes(v) for v in got[key]] == [bytes(v) for v in want[key]]
    else:
      assert got[key].dtype == want[key].dtype, key
      np.testing.assert_array_equal(got[key], want[key], err_msg=key)


WRITERS = {'jax': jax_tfrecord, 'port': tfrecord}
READERS = {
    'jax': lambda path: list(jax_tfrecord.read_examples(path)),
    'port-native': lambda path: list(tfrecord.read_examples(path)),
    'port-python': lambda path: [
        tfrecord._parse_example_py(r)
        for r in tfrecord._read_records_py(path, True)],
}


@pytest.mark.parametrize('writer', sorted(WRITERS))
@pytest.mark.parametrize('reader', sorted(READERS))
def test_records_round_trip_across_packages(tmp_path, writer, reader):
  assert tfrecord.native_available(), tfrecord.native_status()
  path = str(tmp_path / 'x.tfrecord')
  records = [WRITERS[writer].make_example(_features(s)) for s in range(4)]
  WRITERS[writer].write_records(path, records)
  got = READERS[reader](path)
  want = [jax_tfrecord._parse_example_py(r) for r in records]
  assert len(got) == len(want) == 4
  for g, w in zip(got, want):
    _assert_features_equal(g, w)


def test_writers_are_byte_identical(tmp_path):
  records = [tfrecord.make_example(_features(s)) for s in range(4)]
  assert records == [jax_tfrecord.make_example(_features(s))
                     for s in range(4)]
  tfrecord.write_records(str(tmp_path / 'a'), records)
  jax_tfrecord.write_records(str(tmp_path / 'b'), records)
  assert (tmp_path / 'a').read_bytes() == (tmp_path / 'b').read_bytes()


def test_native_and_python_readers_agree_on_raw_records(tmp_path):
  path = str(tmp_path / 'x.tfrecord')
  records = [tfrecord.make_example(_features(s)) for s in range(6)]
  tfrecord.write_records(path, records)
  assert list(tfrecord.read_records(path)) == records
  assert list(tfrecord._read_records_py(path, True)) == records
  for record in records:
    _assert_features_equal(tfrecord.parse_example(record),
                           tfrecord._parse_example_py(record))


# Offsets into a one-record file: the length, its CRC, the payload, the
# payload's CRC.
@pytest.mark.parametrize('where', ('length_crc', 'data', 'data_crc'))
@pytest.mark.parametrize('reader', ('jax', 'port-native', 'port-python'))
def test_flipped_byte_raises_ioerror(tmp_path, where, reader):
  record = tfrecord.make_example(_features(1))
  path = tmp_path / 'x.tfrecord'
  tfrecord.write_records(str(path), [record])
  data = bytearray(path.read_bytes())
  offset = {'length_crc': 9, 'data': 12 + len(record) // 2,
            'data_crc': 12 + len(record) + 1}[where]
  data[offset] ^= 0x40
  path.write_bytes(bytes(data))
  with pytest.raises(IOError):
    READERS[reader](str(path))


def _notesequence(module, seed):
  """A NoteSequence of `module` with every field the wire format carries."""
  rng = np.random.RandomState(seed)
  ns = module.NoteSequence(id=f'ns-{seed}', filename='a/b.mid',
                           ticks_per_quarter=220 + seed, total_time=3.25)
  for _ in range(int(rng.randint(1, 12))):
    start = float(rng.uniform(0, 3))
    ns.notes.append(module.Note(
        pitch=int(rng.randint(0, 128)), velocity=int(rng.randint(1, 128)),
        start_time=start, end_time=start + float(rng.uniform(0.01, 1)),
        program=int(rng.randint(0, 128)), instrument=int(rng.randint(0, 9)),
        is_drum=bool(rng.rand() < 0.3)))
  ns.control_changes = [module.ControlChange(
      time=0.5 * i, control_number=64, control_value=int(v))
      for i, v in enumerate(rng.randint(0, 128, 3))]
  ns.pitch_bends = [module.PitchBend(time=0.25, bend=-int(rng.randint(8192)),
                                     program=3)]
  ns.tempos = [module.TempoChange(time=0.0, qpm=float(rng.uniform(60, 180)))]
  return ns


@pytest.mark.parametrize('seed', range(4))
def test_notesequence_bytes_identical_to_jax(seed):
  ours = noteseq_proto.notesequence_to_bytes(
      _notesequence(note_sequence, seed))
  theirs = jax_noteseq_proto.notesequence_to_bytes(
      _notesequence(jax_note_sequence, seed))
  assert ours == theirs


@pytest.mark.parametrize('seed', range(4))
def test_native_and_python_notesequence_parsers_agree(seed):
  data = noteseq_proto.notesequence_to_bytes(
      _notesequence(note_sequence, seed))
  py = noteseq_proto._notesequence_from_bytes_py(data)
  native = noteseq_proto._notesequence_from_bytes_native(
      tfrecord._load_library(), data)
  assert dataclasses.asdict(py) == dataclasses.asdict(native)
  jax = jax_noteseq_proto.notesequence_from_bytes(data)
  assert dataclasses.asdict(py) == dataclasses.asdict(jax)
  assert noteseq_proto.notesequence_to_bytes(native) == data


@pytest.fixture
def fresh_loader(monkeypatch, tmp_path):
  """The loader's state reset, with its build directory under tmp_path."""
  monkeypatch.setattr(tfrecord, 'BUILD_DIR', tmp_path / 'native')
  monkeypatch.setattr(tfrecord, '_lib', None)
  monkeypatch.setattr(tfrecord, '_tried', False)
  monkeypatch.setattr(tfrecord, '_status', 'not loaded yet')
  return tmp_path / 'native'


def test_library_is_keyed_by_source_and_built_once(fresh_loader, monkeypatch,
                                                   tmp_path):
  path = tfrecord.library_path()
  assert path.parent == fresh_loader
  assert path.name.startswith('libmt3_native-') and path.suffix == '.so'
  results = []
  threads = [threading.Thread(
      target=lambda: results.append(tfrecord._build_library()))
      for _ in range(3)]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  assert results == [path] * 3
  assert sorted(p.name for p in fresh_loader.iterdir()) == [path.name]
  assert tfrecord.native_available()
  assert tfrecord.native_status() == f'native ({path.name})'
  # An edited source builds under another name.
  edited = tmp_path / 'tfrecord.cc'
  edited.write_bytes(tfrecord.NATIVE_SOURCE.read_bytes() + b'// edited\n')
  monkeypatch.setattr(tfrecord, 'NATIVE_SOURCE', edited)
  assert tfrecord.library_path() != path


def test_without_a_compiler_the_python_reader_runs(fresh_loader, monkeypatch,
                                                   tmp_path):
  monkeypatch.setenv('PATH', str(tmp_path))
  monkeypatch.delenv('CXX', raising=False)
  assert not tfrecord.native_available()
  assert tfrecord.native_status().startswith(
      'python (native reader unavailable: no C++ compiler')
  assert not fresh_loader.exists()
  path = str(tmp_path / 'x.tfrecord')
  records = [tfrecord.make_example(_features(s)) for s in range(2)]
  tfrecord.write_records(path, records)
  for got, record in zip(tfrecord.read_examples(path), records):
    _assert_features_equal(got, jax_tfrecord._parse_example_py(record))


def test_a_failing_compiler_raises_its_error(fresh_loader, monkeypatch,
                                             tmp_path):
  cxx = tmp_path / 'broken-g++'
  cxx.write_text('#!/bin/sh\necho "internal compiler error" >&2\nexit 4\n')
  cxx.chmod(0o755)
  monkeypatch.setenv('CXX', str(cxx))
  for _ in range(2):   # no reader is settled on: the next call tries again
    with pytest.raises(RuntimeError, match='internal compiler error') as info:
      tfrecord.native_available()
    assert not isinstance(info.value, tfrecord.NoCompilerError)
  assert list(fresh_loader.iterdir()) == []
  path = str(tmp_path / 'x.tfrecord')
  tfrecord.write_records(path, [tfrecord.make_example(_features(0))])
  with pytest.raises(RuntimeError, match='broken-g\\+\\+ failed'):
    list(tfrecord.read_records(path))
