"""The window's accounting, the idle-share union and the trace reading."""

import json

import pytest

from gpubench import harness


class Clock:
  """A clock that each unit advances by its duration."""

  def __init__(self):
    self.now = 0.0

  def __call__(self):
    return self.now


@pytest.mark.parametrize('durations, seconds, units, elapsed', [
    ([3.0] * 10, 10.0, 4, 12.0),      # the unit that crosses 10 s ends it
    ([2.5] * 10, 10.0, 4, 10.0),      # a unit ending exactly at 10 s counts
    ([20.0], 10.0, 1, 20.0),          # one unit longer than the window
    ([1.0, 9.5, 4.0], 10.0, 2, 10.5),  # uneven units
])
def test_window_ends_with_the_first_unit_at_or_after_seconds(
    durations, seconds, units, elapsed):
  clock = Clock()

  def unit(i):
    clock.now += durations[i]
    return durations[i]

  got_elapsed, results = harness.window(unit, seconds, clock)
  assert len(results) == units
  assert got_elapsed == pytest.approx(elapsed)
  # A rate counts all the work of the units over the time they took.
  assert sum(results) / got_elapsed == pytest.approx(1.0)


def test_union_of_overlapping_intervals():
  intervals = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 12)]
  assert harness.covered(intervals, 0, 10) == pytest.approx(3 + 1 + 2)
  assert harness.gaps(intervals, 0, 10) == [(3, 5), (6, 8)]
  assert harness.covered([], 0, 10) == 0
  assert harness.gaps([], 0, 1) == [(0, 1)]
  # Streams that overlap are not counted twice.
  assert harness.covered([(0, 4), (0, 4), (1, 2)], 0, 4) == 4


def _event(cat, name, ts, dur):
  return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}


def test_idle_share_from_a_synthetic_trace(tmp_path):
  events = [
      _event('user_annotation', harness.WINDOW_MARK, 1000, 100),
      _event('cpu_op', 'aten::mm', 1000, 20),
      _event('cpu_op', 'host_loop', 1040, 50),
      _event('kernel', 'nvjet_a', 1005, 30),
      _event('kernel', 'decode_attention_split_kernel<x>', 1020, 20),
      _event('gpu_memcpy', 'Memcpy DtoH', 1080, 10),
      _event('kernel', 'outside', 1200, 10),
      _event('cuda_runtime', 'cudaLaunchKernel', 1001, 1),
      _event('cuda_runtime', 'cudaLaunchKernelExC', 1002, 1),
      _event('cuda_runtime', 'cudaMemcpyAsync', 1003, 1),
      {'ph': 's', 'cat': 'ac2g', 'name': 'flow', 'ts': 1001},
  ]
  path = tmp_path / 'trace.json'
  path.write_text(json.dumps({'traceEvents': events}))
  s = harness.parse_chrome_trace(str(path))
  assert s.window_s == pytest.approx(100e-6)
  assert s.busy_s == pytest.approx(45e-6)      # [1005, 1040) + [1080, 1090)
  assert s.launches == 2
  assert s.device_s(lambda n: 'decode_attention' in n) == pytest.approx(20e-6)
  gaps = sorted(s.idle_gaps(), key=lambda g: -g[1])
  assert gaps[0] == ('host_loop', pytest.approx(40e-6))   # [1040, 1080)
  b = harness.breakdown([s], [s])
  assert b['device_ops'][0][0] == 'nvjet_a'
  assert len(b['idle_gaps']) == 3


def test_forbidden_modules_compares_whole_top_level_names():
  assert harness.forbidden_modules(['mt3_tpu_torch', 'mt3_tpu_torch.ops',
                                    'jaxtyping', 'flaxen', 'numpy']) == []
  assert harness.forbidden_modules(['mt3_tpu.core.config', 'jax.numpy',
                                    'jaxlib', 'flax.linen']) == [
                                        'flax', 'jax', 'jaxlib', 'mt3_tpu']


def test_result_line_puts_checks_last():
  line = harness.result_line(True, 3, 0, {'setup_s': {'value': 1.0,
                                                       'unit': 's'}},
                             {'platform': 'gpu'},
                             [harness.Check('logit_gap', 0.1, 0.5)])
  out = json.loads(line)
  assert list(out)[-1] == 'checks'
  assert out['checks'] == {'logit_gap': {'value': 0.1, 'limit': 0.5}}
  assert list(out)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                           'device']


def test_stream_seeds_take_large_seeds():
  a = harness.stream_seed(2**31 + 12345, 1)
  assert a != harness.stream_seed(2**31 + 12345, 2)
  assert 0 <= a < 2**63
