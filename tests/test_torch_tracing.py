"""The port's recorder of spans and counters (utils/profiling) on the CPU.

* Off (the default), span() and count() record nothing and enter no
  record_function.
* On, spans nest per thread (parent, root, self time), device spans on
  the CPU record host time only, the buffer keeps the newest records and
  counts the dropped, after_profiler sticks once a profiler has run, and
  a profiler session and trace() place the spans on the trace's clock.
* The call sites count what they say: decode rows x steps and all-done
  checks, the Transcriber's kept tokens and EOS rows; and spans on leave
  tokens and a train step's loss bit-identical.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.codec import vocabulary
from mt3_tpu_torch.core import config as config_lib
from mt3_tpu_torch.infer import decode, transcribe
from mt3_tpu_torch.train import trainer
from mt3_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def recorder():
  """Each test starts with the recorder off and empty, and leaves it so."""
  profiling.disable()
  profiling.reset()
  yield
  profiling.disable()
  profiling.reset()


@pytest.fixture(scope='module')
def tiny():
  cfg = config_lib.tiny_config()
  cfg = dataclasses.replace(
      cfg, model=dataclasses.replace(cfg.model, max_positions=512))
  return cfg, params_lib.init_params(cfg.model,
                                     torch.Generator().manual_seed(0))


def _by_name(spans, name):
  return [s for s in spans if s['name'] == name]


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
  def refuse(*args, **kwargs):
    raise AssertionError('entered while the recorder is off')

  monkeypatch.setattr(torch.profiler, 'record_function', refuse)
  monkeypatch.setattr(torch.cuda, 'Event', refuse)
  assert not profiling.enabled()
  assert profiling.span('a') is profiling.span('b', device=True)
  with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    with profiling.span('a'), profiling.span('b', device=True):
      profiling.count('n', 3)
  got = profiling.collect()
  assert got['spans'] == [] and got['counters'] == {}
  assert got['dropped'] == 0 and 'logmel' in got['kernels']


def test_nesting_gives_parent_root_and_self_time():
  profiling.enable()
  with profiling.span('outer'):
    with profiling.span('a'):
      with profiling.span('a.inner'):
        pass
    with profiling.span('b'):
      pass
  with profiling.span('second'):
    pass
  spans = {s['name']: s for s in profiling.collect()['spans']}
  outer = spans['outer']
  assert outer['parent'] is None and outer['root'] == outer['id']
  assert spans['a']['parent'] == outer['id']
  assert spans['b']['parent'] == outer['id']
  assert spans['a.inner']['parent'] == spans['a']['id']
  assert {spans[n]['root'] for n in ('a', 'b', 'a.inner')} == {outer['id']}
  assert spans['second']['root'] == spans['second']['id'] != outer['id']

  def duration(s):
    return s['end_ns'] - s['start_ns']

  assert outer['self_ns'] == duration(outer) - duration(spans['a']) - (
      duration(spans['b']))
  assert spans['a']['self_ns'] == duration(spans['a']) - duration(
      spans['a.inner'])
  assert spans['b']['self_ns'] == duration(spans['b']) > 0


@pytest.mark.parametrize('device', (True, torch.device('cpu')))
def test_device_span_on_the_cpu_records_host_time_only(monkeypatch, device):
  def refuse(*args, **kwargs):
    raise AssertionError('a CUDA event on the CPU')

  monkeypatch.setattr(torch.cuda, 'Event', refuse)
  profiling.enable()
  with profiling.span('work', device=device):
    torch.ones(64, 64).sum()
  (s,) = profiling.collect()['spans']
  assert s['device_ms'] is None and s['end_ns'] > s['start_ns']


def test_the_buffer_keeps_the_newest_records_and_counts_the_dropped():
  profiling._RECORDER.clear(max_records=3)
  profiling.enable()
  for i in range(5):
    with profiling.span(f's{i}'):
      pass
  got = profiling.collect()
  assert [s['name'] for s in got['spans']] == ['s2', 's3', 's4']
  assert got['dropped'] == 2
  profiling.reset()
  assert profiling._RECORDER.records.maxlen == profiling.MAX_RECORDS


def test_after_profiler_is_set_under_a_profiler_and_stays_set():
  profiling.enable()
  with profiling.span('before'):
    pass
  with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    with profiling.span('during'):
      pass
  with profiling.span('after'):
    pass
  flags = {s['name']: s['after_profiler']
           for s in profiling.collect()['spans']}
  assert flags == {'before': False, 'during': True, 'after': True}
  profiling.reset()
  with profiling.span('reset'):
    pass
  assert not profiling.collect()['spans'][0]['after_profiler']


def test_spans_are_user_annotations_of_a_cpu_profile(tmp_path):
  profiling.enable()
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    with profiling.span('outer.span'):
      with profiling.span('inner.span'):
        torch.ones(32, 32).sum()
      with profiling.span('host.only', annotate=False):
        torch.ones(32, 32).sum()
  prof.export_chrome_trace(str(tmp_path / 't.json'))
  events = json.loads((tmp_path / 't.json').read_text())['traceEvents']
  names = {e['name'] for e in events if e.get('cat') == 'user_annotation'}
  assert {'outer.span', 'inner.span'} <= names
  assert 'host.only' not in names
  assert len(profiling.collect()['spans']) == 3


def test_trace_writes_the_spans_on_the_trace_clock(tmp_path):
  with profiling.trace(str(tmp_path)):
    for i in range(3):
      with profiling.span('step'):
        with profiling.span('step.work'):
          torch.ones(128, 128).sum()
    profiling.count('steps', 3)
  assert not profiling.enabled()
  (trace_path,) = tmp_path.glob('trace.*.json')
  (spans_path,) = tmp_path.glob('spans.*.json')
  assert spans_path.name[len('spans.'):] == trace_path.name[len('trace.'):]
  events = json.loads(trace_path.read_text())['traceEvents']
  written = json.loads(spans_path.read_text())
  assert written['clock'] == 'trace' and written['counters'] == {'steps': 3}
  mine = [e for e in written['traceEvents'] if e['name'].startswith('step')]
  assert len(mine) == 6
  for name in ('step', 'step.work'):
    theirs = sorted(e['ts'] for e in events if e.get('name') == name
                    and e.get('cat') == 'user_annotation')
    ours = sorted(e['ts'] for e in mine if e['name'] == name)
    assert len(theirs) == len(ours) == 3
    assert max(abs(a - b) for a, b in zip(ours, theirs)) < 200.0   # us


@pytest.mark.parametrize('steps_per_iter', (1, 2, 8))
def test_decode_counts_row_steps_and_checks(tiny, steps_per_iter):
  cfg, params = tiny
  encoded = torch.from_numpy(np.random.RandomState(0).randn(
      3, 8, cfg.model.emb_dim).astype(np.float32))
  profiling.enable()
  decode.decode_tokens(params, cfg.model, encoded, 16, forbid_eos=True,
                       steps_per_iter=steps_per_iter)
  got = profiling.collect()
  assert got['counters'] == {'decode.calls': 1, 'decode.row_steps': 3 * 16,
                             'decode.checks': 16 // steps_per_iter}
  (call,) = _by_name(got['spans'], 'decode')
  steps = _by_name(got['spans'], 'decode.step')
  checks = _by_name(got['spans'], 'decode.done_check')
  assert len(steps) == 16 and len(checks) == 16 // steps_per_iter
  assert {s['parent'] for s in steps + checks} == {call['id']}


def test_predict_segments_counts_kept_tokens_and_eos_rows(tiny, monkeypatch):
  cfg, params = tiny
  rng = np.random.RandomState(1)
  served = []

  def planted(params, config, encoded, max_decode_len, **kwargs):
    """Tokens with EOS in some rows and PAD after it, as a decode makes."""
    b = encoded.shape[0]
    tokens = rng.randint(3, 100, (b, max_decode_len)).astype(np.int32)
    for row in range(0, b, 3):
      end = rng.randint(0, max_decode_len)
      tokens[row, end] = vocabulary.EOS_ID
      tokens[row, end + 1:] = vocabulary.PAD_ID
    served.append(tokens)
    return torch.from_numpy(tokens), None

  monkeypatch.setattr(decode, 'decode_tokens', planted)
  t = transcribe.Transcriber(cfg, params, device='cpu')
  audio = np.random.RandomState(0).randn(20 * 1024).astype(np.float32)
  batches = transcribe.audio_to_segments(audio, cfg)
  assert not all(batches[-1].valid)      # a padded last batch
  profiling.enable()
  t.predict_segments(audio)
  kept = np.concatenate([tokens[np.asarray(batch.valid)]
                         for tokens, batch in zip(served, batches)])
  counters = profiling.collect()['counters']
  assert counters['transcribe.tokens_kept'] == int(
      sum(int(v != vocabulary.PAD_ID) for row in kept for v in row))
  assert counters['transcribe.eos_rows'] == sum(
      vocabulary.EOS_ID in row.tolist() for row in kept) > 0


def test_spans_leave_tokens_and_a_train_step_bit_identical(tiny):
  cfg, params = tiny
  encoded = torch.from_numpy(np.random.RandomState(2).randn(
      2, 8, cfg.model.emb_dim).astype(np.float32))
  raw = trainer.make_train_batch(np.random.RandomState(0), 2,
                                 cfg.run.inputs_length,
                                 cfg.run.targets_length, 1, 64)
  raw['encoder_input_frames'] = np.random.RandomState(1).randn(
      2, cfg.run.inputs_length, cfg.spectrogram.hop_width).astype(np.float32)
  del raw['encoder_input_tokens']

  def run():
    tokens, _ = decode.decode_tokens(params, cfg.model, encoded, 16)
    tr = trainer.Trainer(cfg.model, cfg.run, seed=0, device='cpu')
    batch = trainer.model_batch(raw, cfg.spectrogram, 'cpu')
    return tokens, tr.step(batch)['loss']

  off = run()
  profiling.enable()
  on = run()
  assert torch.equal(off[0], on[0])
  assert off[1].item() == on[1].item()
  spans = profiling.collect()['spans']
  (step,) = _by_name(spans, 'train.step')
  for name in ('train.forward', 'train.backward', 'train.optimizer'):
    (phase,) = _by_name(spans, name)
    assert phase['root'] == step['id'] == phase['parent']
  (stage,) = _by_name(spans, 'train.batch')
  assert [s['parent'] for s in _by_name(spans, 'logmel')
          if s['root'] == stage['id']] == [stage['id']]
