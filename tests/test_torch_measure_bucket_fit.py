"""mt3_tpu_torch.tools.bucket_fit on chrome traces written here.

A synthetic trace of a decode: kernel B launched once per layer a step
with durations that grow linearly with the cache index, a fixed host gap
between steps and a longer one after every 16th step (the all-done
check), among other kernels and host events.  Both fits recover the
known fixed term and slope within 1e-6 relative; the bytes of a cache
slot are the per-position bytes of the benchmark's kernel B bound
(gpubench/work.py) over every layer; a trace with too few launches gives
a clear error.
"""

import gzip
import json

import numpy as np
import pytest

from gpubench import work
from mt3_tpu_torch.tools import bucket_fit

LAYERS, STEPS, SPI = 8, 96, 16
A_US, B_US = 12.0, 0.04        # kernel B: A + B * index us a launch
GAP_US, HOST_US, CHECK_US = 3.0, 150.0, 900.0


def decode_trace(steps=STEPS):
  """(chrome trace, start of each step) of a synthetic decode."""
  events, starts, t = [], [], 1000.0
  for k in range(steps):
    starts.append(t)
    for layer in range(LAYERS):
      dur = A_US + B_US * k
      events.append({'ph': 'X', 'cat': 'kernel', 'ts': t, 'dur': dur,
                     'name': 'decode_attention_grouped_tc_kernel<4, 1>'})
      events.append({'ph': 'X', 'cat': 'kernel', 'ts': t + dur, 'dur': 1.5,
                     'name': 'nvjet_hsh_64x8_gemm'})
      events.append({'ph': 'X', 'cat': 'cuda_runtime', 'ts': t, 'dur': 4.0,
                     'name': 'cudaLaunchKernel'})
      t += dur + 1.5 + GAP_US
    t += HOST_US + (CHECK_US if (k + 1) % SPI == 0 else 0.0)
  return {'traceEvents': events}, np.array(starts)


def write(path, trace, gz=True):
  data = json.dumps(trace).encode()
  path.write_bytes(gzip.compress(data) if gz else data)


def test_both_fits_recover_the_known_lines(tmp_path):
  trace, _ = decode_trace()
  write(tmp_path / 'trace.json.gz', trace)
  kernels = bucket_fit.load_kernels(str(tmp_path))
  xi, yi, xii, yii, left_out, steps = bucket_fit.step_series(
      kernels, LAYERS, SPI)
  assert steps == STEPS and left_out == STEPS // SPI - 1 + (STEPS % SPI > 0)
  # (i): step k's interval; the intervals that hold a check are out.
  fixed, slope = bucket_fit.fit(xi, yi)
  per_launch = A_US + 1.5 + GAP_US
  np.testing.assert_allclose(
      [fixed, slope],
      [(LAYERS * per_launch + HOST_US) / 1e3, LAYERS * B_US / 1e3],
      rtol=1e-6)
  assert len(xi) == STEPS - 1 - left_out
  # (ii): the L kernel-B durations of step k.
  fixed, slope = bucket_fit.fit(xii, yii)
  np.testing.assert_allclose([fixed, slope],
                             [LAYERS * A_US / 1e3, LAYERS * B_US / 1e3],
                             rtol=1e-6)
  assert len(xii) == STEPS - left_out


def test_main_prints_both_fits_and_the_bandwidth(tmp_path, capsys):
  trace, _ = decode_trace()
  write(tmp_path / 'trace.json', trace, gz=False)
  bucket_fit.main([str(tmp_path), '--batch', '1024', '--spi', str(SPI),
                   '--kv_heads', '1', '--top', '2'])
  out = capsys.readouterr().out
  assert 'top device kernels by total time:' in out
  assert (f'kernel B: {STEPS * LAYERS} launches = {STEPS} decode steps of '
          f'{LAYERS} layers') in out
  assert f'fit (ii) kernel B time: fixed {LAYERS * A_US / 1e3:.3f}' in out
  nbytes = bucket_fit.slot_bytes(LAYERS, 1024, 1, 64, 4)
  gbps = nbytes / (LAYERS * B_US * 1e-6) / 1e9
  assert f'effective cache-read BW (fit ii): {gbps:.0f} GB/s' in out


@pytest.mark.parametrize('bits,elt', [(4, 2), (8, 2), (None, 2), (None, 4)])
@pytest.mark.parametrize('kv', [1, 6])
def test_slot_bytes_are_chip_smokes_per_position_bytes(bits, elt, kv):
  b, h, d = 1024, 6, 64
  per_position = (work.b_variant_bytes(b, kv, h, d, 101, bits, elt)
                  - work.b_variant_bytes(b, kv, h, d, 100, bits, elt))
  assert bucket_fit.slot_bytes(LAYERS, b, kv, d, bits or 8 * elt) == (
      LAYERS * per_position)


def test_too_few_launches_is_a_clear_error(tmp_path):
  trace, _ = decode_trace(steps=2)
  write(tmp_path / 'trace.json.gz', trace)
  with pytest.raises(SystemExit, match='found 16 kernel B launches'):
    bucket_fit.main([str(tmp_path)])
  with pytest.raises(SystemExit, match='whole number of decode steps'):
    bucket_fit.main([str(tmp_path), '--layers', '5'])
  with pytest.raises(SystemExit, match='no chrome trace'):
    bucket_fit.main([str(tmp_path / 'missing')])
