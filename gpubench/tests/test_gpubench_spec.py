"""BENCHMARK.json against the benchmark's contract, and a cell found from
files alone."""

import json
import pathlib
import re
import time

import pytest
import torch

from gpubench import driver, spec
from gpubench.tests import contract, tiny

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TEXT = re.compile(r'^[^\n\t]{1,200}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')


def test_top_level_keys():
  assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                        'workloads', 'end_to_end', 'per_layer'}
  assert 1 <= BENCH['run_seconds'] <= 51
  assert len(json.dumps(BENCH)) <= 64 * 1024


def test_paths_and_command():
  assert 1 <= len(BENCH['paths']) <= 16
  for path in BENCH['paths']:
    assert PATH.match(path) and not path.startswith('/') and '..' not in path
    assert not path.endswith('_torch')
  assert len(BENCH['command']) <= 32
  for word in BENCH['command']:
    assert TEXT.match(word) and not word.startswith('/') and '..' not in word
  assert (REPO / BENCH['command'][1]).exists()


def test_names_units_and_texts():
  names = []
  for c in BENCH['configs']:
    assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.match(c['name']) and TEXT.match(c['source'])
    assert TEXT.match(c['why']) and len(c['reduced']) <= 16
    assert all(NAME.match(k) for k in c['reduced'])
    assert c['file'].startswith('gpubench/') and (REPO / c['file']).exists()
    names.append(c['name'])
  assert len(set(names)) == len(names)
  cells = []
  for w in BENCH['workloads']:
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    for key in ('name', 'config', 'traffic'):
      assert NAME.match(w[key])
    assert w['chips'] in (1, 4) and TEXT.match(w['why'])
    assert w['config'] in names
    cells.append(w['name'])
  assert len(set(cells)) == len(cells)
  assert len({(w['config'], w['traffic']) for w in BENCH['workloads']}) == len(
      cells)
  metrics = BENCH['end_to_end'] + BENCH['per_layer']
  assert len({m['name'] for m in metrics}) == len(metrics)
  for m in metrics:
    assert NAME.match(m['name']) and UNIT.match(m['unit'])
    assert m['better'] in ('lower', 'higher')
    assert set(m.get('workloads', cells)) <= set(cells)
  for m in BENCH['end_to_end']:
    assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                      'source'}
    assert m['source'] in ('host_clock', 'device_trace')
    assert 0.01 <= m['bound'] <= 0.25
  e2e = {m['name']: m for m in BENCH['end_to_end']}
  assert 'setup_s' in e2e and 'workloads' not in e2e['setup_s']
  for m in BENCH['per_layer']:
    assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                      'layer', 'moves'}
    assert TEXT.match(m['layer'])
    assert m['source'] in ('device_trace', 'program_span', 'program_counter',
                           'host_clock')
    moved = e2e[m['moves']]
    assert set(m['workloads']) <= set(moved.get('workloads', cells))
    if m['name'].endswith('_roofline') or 'mfu' in m['name']:
      assert m['unit'] == '%'
    assert (REPO / 'gpubench' / 'metrics' / f'{m["name"]}.py').exists()


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
  for w in BENCH['workloads']:
    cell = spec.Cell(w['name'], REPO)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert (REPO / 'gpubench' / 'traffic' / f'{w["traffic"]}.json').exists()
    assert (REPO / 'gpubench' / 'limits' / f'{w["name"]}.json').exists()
  for c in BENCH['configs']:
    assert any(w['config'] == c['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('entry', BENCH['configs'],
                         ids=[c['name'] for c in BENCH['configs']])
def test_config_files_state_what_the_port_runs(entry):
  """Each configuration file against its own family (MT3's T5 where it
  names none), with its cuts and assumed sizes written down."""
  contract.check_config(REPO, entry)


def test_a_cell_is_found_from_files_alone(tmp_path, capsys):
  """Throwaway cells made of new files and new entries only (a
  configuration, a traffic mix, a per-layer metric, limits) run through
  the harness unchanged; a configuration with an int4 decode cache hands
  the readers its bits and its activations' width."""
  root = tiny.make_root(tmp_path, limits={'tiny.bulk': {'logit_gap': 1.0},
                                          'tiny.bulk_int4': {'logit_gap': 1.0}})
  bench = json.loads((root / 'BENCHMARK.json').read_text())
  (root / 'gpubench' / 'metrics' / 'rows_traced.py').write_text(
      'def read(r):\n  return float(r.counters.get("rows", 0)) or None\n')
  (root / 'gpubench' / 'metrics' / 'cache_bits.py').write_text(
      'def read(r):\n'
      '  return r.counters.get("kv_bits") or 8 * r.counters["elt"]\n')
  bench['per_layer'] += [
      {'name': 'rows_traced', 'unit': 'rows', 'better': 'higher',
       'source': 'program_counter', 'layer': 'decode per token',
       'moves': 'audio_s_per_s', 'workloads': ['tiny.bulk']},
      {'name': 'cache_bits', 'unit': 'bits', 'better': 'lower',
       'source': 'program_counter', 'layer': 'decode per token',
       'moves': 'audio_s_per_s', 'workloads': ['tiny.bulk', 'tiny.bulk_int4']}]
  (root / 'BENCHMARK.json').write_text(json.dumps(bench))
  cell = spec.Cell('tiny.bulk', root)
  assert cell.traffic['segments'] == 8 and cell.config['name'] == 'tiny_mt3'
  lines = []
  for name, trace in (('tiny.bulk', False), ('tiny.bulk', True),
                      ('tiny.bulk_int4', True)):
    assert driver.run(spec.Cell(name, root), 2**31 + 7, 0.2, trace,
                      torch.device('cpu'), time.perf_counter(),
                      out=lines.append) == 0
  plain, traced, int4 = (json.loads(line) for line in lines)
  assert plain['correct'] and traced['correct'] and int4['correct']
  assert set(plain['metrics']) == {'audio_s_per_s', 'peak_mem_gib', 'setup_s'}
  assert traced['metrics']['rows_traced']['value'] == 8.0
  assert traced['metrics']['cache_bits']['value'] == 16    # bf16 cache
  assert int4['metrics']['cache_bits']['value'] == 4
