"""The port's logs and profiling against mt3_tpu's.

* utils/tensorboard is a whole copy of the JAX package's module; for the
  same scalars, with time.time and the host name fixed in both, the two
  event files parse to the same records (and are byte-identical), and the
  records decode to the file version, then each scalar's tag, value and
  step; utils/events reads the (tag, step) pairs back from either file.
* utils/profiling keeps the JAX package's ThroughputMeter; trace() writes a
  torch.profiler Chrome trace; Timer.elapsed waits on the result's CUDA
  streams (none on the CPU, so it only reads the clock).
"""

import inspect
import json
import re
import struct

import numpy as np
import pytest
import torch

from mt3_tpu.data import tfrecord as jax_tfrecord
from mt3_tpu.utils import profiling as jax_profiling
from mt3_tpu.utils import tensorboard as jax_tensorboard
from mt3_tpu_torch.data import tfrecord
from mt3_tpu_torch.utils import events, profiling, tensorboard

_REFERENCE_CHECKOUT = re.compile(r'/[^\s:()]*/reference/mt3/')


def _rewritten(source):
  return _REFERENCE_CHECKOUT.sub(
      'mt3/', source.replace('mt3_tpu.', 'mt3_tpu_torch.'))


def test_tensorboard_module_is_pinned():
  mine = inspect.getsource(tensorboard).splitlines()
  orig = _rewritten(inspect.getsource(jax_tensorboard)).splitlines()
  assert mine[1:] == orig[1:]
  assert mine[0].startswith(orig[0].rstrip('.'))


def test_throughput_meter_is_pinned():
  assert inspect.getsource(profiling.ThroughputMeter) == inspect.getsource(
      jax_profiling.ThroughputMeter)


SCALARS = [({'loss': 3.14}, 1),
           ({'train/loss': 2.71, 'train/accuracy': 0.5,
             'train/learning_rate': 1e-3}, 2),
           ({'eval/Onset F1': 0.25, 'eval/Frame F1': np.float32(0.125)},
            1000)]


def _write(module, directory, monkeypatch):
  clock = iter(1_700_000_000.0 + 0.25 * i for i in range(100))
  monkeypatch.setattr(module.time, 'time', lambda: next(clock))
  monkeypatch.setattr(module.socket, 'gethostname', lambda: 'host')
  writer = module.SummaryWriter(str(directory))
  for scalars, step in SCALARS:
    writer.add_scalars(scalars, step)
  writer.close()
  return writer.path


def _decode(record):
  """(wall_time, step, file_version, [(tag, value)]) of an Event."""
  wall, step, version, values = None, None, None, []
  for field, _, value in tfrecord._iter_fields(record):
    if field == 1:
      wall = struct.unpack('<d', value)[0]
    elif field == 2:
      step = value
    elif field == 3:
      version = value.decode()
    elif field == 5:
      for _, _, entry in tfrecord._iter_fields(value):
        parts = dict((f, v) for f, _, v in tfrecord._iter_fields(entry))
        values.append((parts[1].decode(), struct.unpack('<f', parts[2])[0]))
  return wall, step, version, values


def test_event_files_parse_to_the_same_records(tmp_path, monkeypatch):
  ours = _write(tensorboard, tmp_path / 'ours', monkeypatch)
  theirs = _write(jax_tensorboard, tmp_path / 'theirs', monkeypatch)
  assert ours.rsplit('/', 1)[1] == theirs.rsplit('/', 1)[1] == (
      'events.out.tfevents.1700000000.host')
  records = list(tfrecord.read_records(ours))
  assert records == list(jax_tfrecord.read_records(theirs))
  with open(ours, 'rb') as a, open(theirs, 'rb') as b:
    assert a.read() == b.read()
  decoded = [_decode(r) for r in records]
  # The file name read the clock first.
  assert decoded[0] == (1_700_000_000.25, None, 'brain.Event:2', [])
  want = [(step, tag, float(np.float32(value)))
          for scalars, step in SCALARS for tag, value in scalars.items()]
  assert [(step, values[0][0], values[0][1])
          for _, step, _, values in decoded[1:]] == want
  walls = [wall for wall, _, _, _ in decoded]
  assert walls == sorted(walls) and len(set(walls)) == len(walls)


def test_scalar_events_reads_back_what_either_writer_wrote(tmp_path,
                                                         monkeypatch):
  want = [(tag, step) for scalars, step in SCALARS for tag in scalars]
  for module, name in ((tensorboard, 'ours'), (jax_tensorboard, 'theirs')):
    path = _write(module, tmp_path / name, monkeypatch)
    assert events.scalar_events(path) == want, name


def test_trace_writes_a_chrome_trace(tmp_path):
  with profiling.trace(str(tmp_path / 'trace')) as profiler:
    x = torch.randn(64, 64)
    (x @ x).sum()
  (path,) = (tmp_path / 'trace').iterdir()
  assert path.name.startswith('trace.') and path.suffix == '.json'
  events = json.loads(path.read_text())['traceEvents']
  assert any('mm' in e.get('name', '') for e in events)
  assert any('mm' in e.name for e in profiler.events())


def test_trace_writes_even_when_the_block_raises(tmp_path):
  with pytest.raises(ValueError):
    with profiling.trace(str(tmp_path)):
      raise ValueError('inside')
  assert len(list(tmp_path.iterdir())) == 1


def test_timer_and_cuda_devices():
  timer = profiling.Timer()
  x = torch.ones(3)
  assert profiling._cuda_devices({'a': [x, (x, 2)], 'b': None}) == set()
  meta = torch.empty(2, device='meta')
  assert profiling._cuda_devices([meta]) == set()
  first = timer.elapsed({'loss': x})
  assert 0 <= first <= timer.elapsed()


def test_throughput_meter_counts_audio_seconds(monkeypatch):
  clock = iter(float(t) for t in range(10))
  monkeypatch.setattr(profiling.time, 'perf_counter', lambda: next(clock))
  meter = profiling.ThroughputMeter(window=3)
  assert meter.steps_per_second is None
  for _ in range(5):
    meter.update(audio_seconds=2.0)
  assert meter.steps_per_second == 1.0
  assert meter.audio_seconds_per_second == 2.0
