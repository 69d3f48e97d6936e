"""On the card: each cell's control comes out as not correct on three
seeds, a sound short run of each cell is correct, and kernel B's roofline
of a cell with an int4 cache stays within 100%.  Skips without a CUDA
device.  Run on the card with `python -m pytest gpubench/tests -m card`
(some minutes: every cell's set-up, four times)."""

import json
import pathlib
import subprocess
import sys
import time

import pytest

from gpubench.tests import tiny

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in BENCH['workloads']]


@pytest.mark.card
@pytest.mark.parametrize('cell', CELLS)
def test_the_control_is_not_correct(card, cell):
  out = subprocess.run(
      [sys.executable, 'gpubench/control.py', '--workload', cell, '--seeds',
       '2147483701,2147483702,2147483703', '--plant', 'control',
       '--seconds', '1'], cwd=REPO, capture_output=True, text=True,
      check=True, timeout=1800).stdout
  rows = [json.loads(line) for line in out.splitlines()
          if line.startswith('{')]
  assert len(rows) == 3
  for row in rows:
    assert not row['correct'], row['checks']


@pytest.mark.card
@pytest.mark.parametrize('cell', CELLS)
def test_a_short_run_is_correct(card, cell):
  done = subprocess.run(
      [sys.executable, 'gpubench/run.py', '--workload', cell, '--seed',
       '2147483704', '--seconds', '2', '--trace', '0'], cwd=REPO,
      capture_output=True, text=True, timeout=900)
  assert done.returncode == 0, done.stderr[-2000:]
  assert json.loads(done.stdout.splitlines()[-1])['correct']


@pytest.mark.card
def test_an_int4_cache_roofline_stays_within_its_bound(card, tmp_path):
  """A cell of new files only, mt3 at full width with an int4 self cache
  and int8 cross K/V at b=64: the bytes counted for kernel B follow the
  configuration's cache, so its share of the roofline is at most 100%."""
  sys.path.insert(0, str(REPO / 'gpubench'))
  import run as entry
  entry._environment()
  from gpubench import driver, spec
  root = tiny.make_root(tmp_path)
  bench = json.loads((root / 'BENCHMARK.json').read_text())
  cfg = json.loads((REPO / 'gpubench' / 'configs' / 'mt3.json').read_text())
  cfg['model'].update(tiny.INT4)
  (root / 'gpubench' / 'configs' / 'card_mt3_int4.json').write_text(
      json.dumps(cfg))
  (root / 'gpubench' / 'traffic' / 'card_bulk_b64.json').write_text(
      json.dumps({'kind': 'bulk', 'segments': 64, 'forbid_eos': True,
                  'steps_per_check': 16, 'check_rows': 2,
                  'trace_from_index': 496, 'trace_steps': 32}))
  bench['configs'].append({'name': 'card_mt3_int4', 'source': 'test',
                           'file': 'gpubench/configs/card_mt3_int4.json',
                           'reduced': [], 'why': 'int4 cache'})
  bench['workloads'].append({'name': 'card.bulk_int4', 'config':
                             'card_mt3_int4', 'traffic': 'card_bulk_b64',
                             'chips': 1, 'why': 'int4 cache'})
  for m in bench['per_layer']:
    if 'mt3.bulk_b3072' in m.get('workloads', []):
      m['workloads'].append('card.bulk_int4')
  (root / 'BENCHMARK.json').write_text(json.dumps(bench))
  lines = []
  import torch
  assert driver.run(spec.Cell('card.bulk_int4', root), 2147483705, 1.0, True,
                    card, time.perf_counter(), out=lines.append) == 0
  share = json.loads(lines[-1])['metrics']['decode_attn_roofline']['value']
  print(f'decode_attn_roofline with an int4 cache at b=64: {share!r} %',
        torch.cuda.get_device_name(card))
  assert 0 < share <= 100
