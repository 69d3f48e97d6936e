"""The readers of the program's own spans and counters
(gpubench/program_spans.py): whole traced and untraced runs of the tiny
cells on the CPU, the readers' arithmetic on planted records, and a
program without the recorder."""

import json
import time

import pytest
import torch

from gpubench import driver, harness, program_spans, spec
from gpubench.tests import tiny
from mt3_tpu_torch.utils import profiling

SEED = 2**31 + 21
NEW = {'decode_dispatch_ms_per_step', 'decode_dispatch_ms_per_step.clip',
       'check_wait_ms_per_step', 'useful_token_share.clip',
       'batch_stage_ms_per_step', 'train_forward_ms_per_step',
       'train_backward_ms_per_step', 'train_optimizer_ms_per_step'}
# Read from CUDA events: no number from a CPU run.
DEVICE = {'train_forward_ms_per_step', 'train_backward_ms_per_step',
          'train_optimizer_ms_per_step'}
PROGRAM_SPANS = {'tiny.bulk': 'decode.model', 'tiny.clip': 'decode.model',
                 'tiny.train': 'train.step'}


@pytest.fixture(scope='module')
def root(tmp_path_factory):
  return tiny.make_root(tmp_path_factory.mktemp('bench'))


@pytest.fixture(autouse=True)
def recorder_off():
  profiling.disable()
  profiling.reset()
  yield
  profiling.disable()
  profiling.reset()


def _run(root, cell, trace, seconds=0.5):
  lines = []
  assert driver.run(spec.Cell(cell, root), SEED, seconds, trace,
                    torch.device('cpu'), time.perf_counter(),
                    out=lines.append) == 0
  return json.loads(lines[-1])


@pytest.mark.parametrize('cell', sorted(PROGRAM_SPANS))
def test_a_traced_run_reads_each_new_metric_of_its_cell(root, cell,
                                                        monkeypatch):
  """Each new host metric of the cell reads a number; the device ones
  read none on the CPU.  The profiled sessions that the breakdown reads
  (on the CPU each records the host's calls) hold the program's spans,
  which cover most of the traced window."""
  sessions = []
  breakdown = harness.breakdown

  def keep(op_sessions, gap_sessions, top=10):
    sessions.extend(op_sessions + gap_sessions)
    return breakdown(op_sessions, gap_sessions, top)

  monkeypatch.setattr(harness, 'breakdown', keep)
  result = _run(root, cell, True)
  assert result['correct'], result['checks']
  wanted = {m['name'] for m in spec.Cell(cell, root).per_layer} & NEW
  assert wanted
  assert set(result['metrics']) & NEW == wanted - DEVICE
  for name in wanted - DEVICE:
    assert result['metrics'][name]['value'] > 0, name
  assert 'breakdown' in result

  def covered(session):
    spans = [(s, e) for name, s, e in session.host
             if name == PROGRAM_SPANS[cell]]
    return harness.covered(spans, session.lo, session.hi) / session.window_s

  assert max(covered(s) for s in sessions if s.window_s > 0) > 0.5


def test_an_untraced_run_leaves_the_recorder_off(root):
  result = _run(root, 'tiny.clip', False)
  assert result['correct'] and not set(result['metrics']) & NEW
  assert not profiling.enabled()
  assert profiling.collect()['spans'] == []


def _span(name, id_, parent=None, root=None, ms=1.0, device_ms=None,
          after=False):
  return {'name': name, 'id': id_, 'parent': parent,
          'root': id_ if root is None else root, 'start_ns': 0,
          'end_ns': int(ms * 1e6), 'after_profiler': after,
          'device_ms': device_ms}


def test_the_readers_arithmetic_on_planted_records(monkeypatch):
  spans = [
      # A clean decode of 2 steps and 1 check, one of 1 step and 1 check,
      # and one that closed after the profiler ran.
      _span('decode', 1), _span('decode.done_check', 2, 1, 1, ms=0.5),
      _span('decode.step', 3, 1, 1, ms=2.0),
      _span('decode.step', 4, 1, 1, ms=4.0),
      _span('decode', 5), _span('decode.done_check', 6, 5, 5, ms=1.0),
      _span('decode.step', 7, 5, 5, ms=3.0),
      _span('decode', 8, after=True),
      _span('decode.step', 9, 8, 8, ms=100.0, after=True),
      # Train steps: two forwards in the first (microbatches).
      _span('train.step', 10),
      _span('train.forward', 11, 10, 10, device_ms=2.0),
      _span('train.forward', 12, 10, 10, device_ms=3.0),
      _span('train.step', 13),
      _span('train.forward', 14, 13, 13, device_ms=7.0),
      _span('train.step', 15),
      _span('train.forward', 16, 15, 15, device_ms=6.0),
      _span('train.step', 17, after=True),
      _span('train.forward', 18, 17, 17, device_ms=100.0, after=True),
      _span('train.batch', 19, ms=1.0), _span('train.batch', 20, ms=9.0),
      _span('train.batch', 21, ms=2.0),
      _span('train.batch', 22, ms=100.0, after=True)]
  got = {'spans': spans, 'counters': {'decode.row_steps': 40,
                                      'transcribe.tokens_kept': 30}}
  monkeypatch.setattr(program_spans, 'collected', lambda: got)
  assert program_spans.per_decode_step('decode.step') == pytest.approx(3.0)
  assert program_spans.per_decode_step('decode.done_check') == (
      pytest.approx(0.5))
  assert program_spans.device_ms_per_train_step('train.forward') == 6.0
  assert program_spans.host_ms('train.batch') == pytest.approx(2.0)
  reader = spec.load_reader(spec.HERE / 'metrics', 'useful_token_share.clip')
  assert reader.read(None) == pytest.approx(75.0)
  spans[11]['device_ms'] = None      # a CPU run's spans
  assert program_spans.device_ms_per_train_step('train.forward') is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
  """An older program (the parent of the change that added the
  recorder): the readers load, turn nothing on and read None."""
  monkeypatch.delattr(profiling, 'collect')
  for name in sorted(NEW):
    reader = spec.load_reader(spec.HERE / 'metrics', name)
    assert reader.read(None) is None, name
  assert not profiling.enabled()
