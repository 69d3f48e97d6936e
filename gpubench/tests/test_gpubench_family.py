"""A configuration of another model family joins the benchmark from new
files alone: its family module (gpubench/families/<name>.py), its
configuration file with a cut and an assumed size written down, a traffic
kind with its own control and faults (gpubench/modes/<kind>.py), limits
and entries in BENCHMARK.json.  The stand-in family is the port's tiny
T5 under ids of its own (gpubench/tests/tiny_other/)."""

import copy
import json
import pathlib
import shutil
import time

import pytest
import torch

from gpubench import driver, faults, serving, spec
from gpubench.tests import contract, tiny

HERE = pathlib.Path(__file__).resolve().parent
SEEDS = (2**31 + 21, 2**31 + 22)
CELL = 'tiny_other.bulk'
KIND = 'tiny_other_bulk'
# End id 5, and id 0 (MT3's PAD) is an id like any other.
CONFIG = {
    'name': 'tiny_other', 'family': 'tiny_other', 'source': 'test',
    'dtype': 'bfloat16',
    'model': dict(tiny.TINY_MODEL, vocab_size=64, num_decoder_layers=1),
    'run': {'inputs_length': 8, 'targets_length': 16},
    'end_id': 5, 'never_served': [],
    'reduced': ['num_decoder_layers'], 'published': {'num_decoder_layers': 2},
    'assumed': ['features: seeded normal draws in place of a front end'],
}
ENTRY = {'name': 'tiny_other', 'source': 'test',
         'file': 'gpubench/configs/tiny_other.json',
         'reduced': ['num_decoder_layers'], 'why': 'another family, tiny'}
METRICS = {
    'end_to_end': {'name': 'rows_per_s.tiny_other', 'unit': 'rows/s',
                   'better': 'higher', 'bound': 0.25, 'source': 'host_clock',
                   'workloads': [CELL]},
    'per_layer': {'name': 'rows_traced.tiny_other', 'unit': 'rows',
                  'better': 'higher', 'source': 'program_counter',
                  'layer': 'decode per token',
                  'moves': 'rows_per_s.tiny_other', 'workloads': [CELL]},
}


@pytest.fixture(scope='module')
def root(tmp_path_factory):
  root = tiny.make_root(tmp_path_factory.mktemp('bench'))
  bench = root / 'gpubench'
  (bench / 'families').mkdir()
  shutil.copy(HERE / 'tiny_other' / 'family.py',
              bench / 'families' / 'tiny_other.py')
  shutil.copy(HERE / 'tiny_other' / 'mode.py', bench / 'modes' / f'{KIND}.py')
  (bench / 'configs' / 'tiny_other.json').write_text(json.dumps(CONFIG))
  (bench / 'traffic' / f'{KIND}.json').write_text(json.dumps(
      {'kind': KIND, 'segments': 8, 'check_rows': 8}))
  (bench / 'limits' / f'{CELL}.json').write_text(json.dumps(
      {'logit_gap': 0.05}))
  (bench / 'metrics' / 'rows_traced.tiny_other.py').write_text(
      'def read(r):\n  return r.counters.get("rows")\n')
  spec_ = json.loads((root / 'BENCHMARK.json').read_text())
  spec_['configs'].append(ENTRY)
  spec_['workloads'].append({'name': CELL, 'config': 'tiny_other',
                             'traffic': KIND, 'chips': 1,
                             'why': 'another family, tiny'})
  for key, metric in METRICS.items():
    spec_[key].append(metric)
  (root / 'BENCHMARK.json').write_text(json.dumps(spec_))
  return root


def _run(root, seed, trace=False, plant=None):
  lines = []
  assert driver.run(spec.Cell(CELL, root), seed, 0.2, trace,
                    torch.device('cpu'), time.perf_counter(),
                    out=lines.append, plant=plant) == 0
  return json.loads(lines[-1])


def test_another_family_joins_from_files_alone(root):
  """No file that the repository's gpubench/ holds is edited; the new
  configuration passes the contract check, and its cell runs correct,
  plain and traced."""
  for path in (tiny.REPO / 'gpubench').rglob('*'):
    if path.is_file() and '__pycache__' not in path.parts:
      copied = root / path.relative_to(tiny.REPO)
      assert copied.read_bytes() == path.read_bytes(), path
  contract.check_config(root, ENTRY)
  assert spec.Cell(CELL, root).family().ids(CONFIG) == {'end_id': 5,
                                                        'never': ()}
  plain = _run(root, SEEDS[0])
  traced = _run(root, SEEDS[0], trace=True)
  assert plain['correct'] and traced['correct'], (plain['checks'],
                                                  traced['checks'])
  assert set(plain['metrics']) == {'rows_per_s.tiny_other', 'setup_s'}
  assert traced['metrics'] == {'rows_traced.tiny_other': {'value': 8,
                                                          'unit': 'rows'}}


@pytest.mark.parametrize('plant', ['control', 'token', 'half_batch'])
def test_its_own_control_and_faults_are_not_correct(root, plant):
  """The kind's CONTROL and FAULTS, found by faults.plant from its mode
  file, read `correct` false where sound runs of the same seeds pass."""
  seeds = SEEDS if plant == 'control' else SEEDS[:1]
  for seed in seeds:
    result = _run(root, seed, plant=faults.plant(KIND, plant))
    assert not result['correct'] and result['failed'] > 0, result['checks']
    sound = _run(root, seed)
    assert sound['correct'], sound['checks']


def _broken(case):
  """(configuration, BENCHMARK.json entry) that break the contract."""
  cfg, entry = copy.deepcopy(CONFIG), copy.deepcopy(ENTRY)
  if case == 'entry_reduces_a_key_the_file_does_not':
    entry['reduced'].append('num_encoder_layers')
  elif case == 'reduced_key_without_published_value':
    cfg['published'] = {}
  elif case == 'no_family_with_assumed':
    cfg = json.loads((tiny.REPO / 'gpubench' / 'configs' / 'mt3.json')
                     .read_text())
    cfg['assumed'] = ['a size set by hand']
    entry['reduced'] = []
  elif case == 'family_check_raises':
    cfg['end_id'] = cfg['model']['vocab_size']
  elif case == 'width_cut':
    _cut(cfg, entry, 'emb_dim', 2 * cfg['model']['emb_dim'])
  elif case == 'cut_not_below_published':
    cfg['published']['num_decoder_layers'] = 1
  elif case == 'share_not_declared':
    _cut(cfg, entry, 'vocab_size', 8 * cfg['model']['vocab_size'])
  elif case == 'share_holds_less_than_its_part':
    _cut(cfg, entry, 'vocab_size', 8 * cfg['model']['vocab_size'] + 1)
    cfg['chip_share'] = {'vocab_size': 8}
  elif case == 'assumed_ends_in_a_newline':
    cfg['assumed'] = ['features: seeded normal draws\n']
  return cfg, entry


def _cut(cfg, entry, key, published):
  cfg['reduced'].append(key)
  entry['reduced'].append(key)
  cfg['published'][key] = published


def _check(root, case, cfg, entry):
  entry['file'] = f'gpubench/configs/contract_{case}.json'
  (root / entry['file']).write_text(json.dumps(cfg))
  contract.check_config(root, entry)


@pytest.mark.parametrize('case', ['entry_reduces_a_key_the_file_does_not',
                                  'reduced_key_without_published_value',
                                  'no_family_with_assumed',
                                  'family_check_raises',
                                  'width_cut',
                                  'cut_not_below_published',
                                  'share_not_declared',
                                  'share_holds_less_than_its_part',
                                  'assumed_ends_in_a_newline'])
def test_the_contract_refuses(root, case):
  cfg, entry = _broken(case)
  with pytest.raises(AssertionError):
    _check(root, case, cfg, entry)


def test_the_contract_takes_a_chip_share(root):
  """A vocabulary sliced over 8 chips that share the layer, as the file
  declares under `chip_share`, is a cut the contract takes."""
  cfg, entry = copy.deepcopy(CONFIG), copy.deepcopy(ENTRY)
  _cut(cfg, entry, 'vocab_size', 8 * cfg['model']['vocab_size'] - 3)
  cfg['chip_share'] = {'vocab_size': 8}
  _check(root, 'chip_share', cfg, entry)


def test_the_checks_take_the_family_ids():
  """serving's checks under another family's ids: id 0 may be served, and
  a row ends at the family's end id, not at MT3's EOS."""
  logits = torch.zeros((1, 4, 8))
  logits[0, :, 0] = 1.0          # id 0 is the reference's best everywhere
  tokens = torch.tensor([[0, 1, 5, 0]])
  ids = {'end_id': 5, 'never': ()}
  assert serving.served_lengths(tokens).tolist() == [2]
  assert serving.served_lengths(tokens, end_id=5).tolist() == [3]
  assert serving.gaps(logits, tokens, False)[0, 0] == serving.NOT_ALLOWED
  assert serving.gaps(logits, tokens, False, **ids).tolist() == [
      [0.0, 1.0, 1.0, 0.0]]
  assert serving.gaps(logits, tokens, True, **ids)[0, 2] == (
      serving.NOT_ALLOWED)
