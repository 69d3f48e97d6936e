"""What decides `correct`, shown to fail: the control (the reference in
the next lower precision, fp8, in the program's place) and each fault a
cell can have (gpubench/faults.py), planted underneath the timed path of
a whole run of the harness, at tiny sizes on the CPU."""

import json
import time

import pytest
import torch

from gpubench import driver, faults, spec
from gpubench.tests import tiny

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
  return tiny.make_root(tmp_path_factory.mktemp('bench'))


def _run(root, cell, seed, seconds=0.2, plant=None):
  lines = []
  assert driver.run(spec.Cell(cell, root), seed, seconds, False,
                    torch.device('cpu'), time.perf_counter(),
                    out=lines.append, plant=plant) == 0
  return json.loads(lines[-1])


def _kind(cell):
  return tiny.TRAFFIC[tiny.CELLS[cell][1]]['kind']


@pytest.mark.parametrize('cell', sorted(tiny.CELLS))
def test_sound_runs_are_correct(root, cell):
  for seed in SEEDS[:2]:
    result = _run(root, cell, seed)
    assert result['correct'], result['checks']
    assert result['failed'] == 0


@pytest.mark.parametrize('cell', tiny.PLAIN)
def test_the_control_is_not_correct(root, cell):
  """The control through the same run and the same checks as the
  program's: `correct` reads false on every seed, and every number it
  fails is one that sound runs of those seeds keep under its limit."""
  for seed in SEEDS:
    result = _run(root, cell, seed, seconds=0.1,
                  plant=faults.plant(_kind(cell), 'control'))
    assert not result['correct'], result['checks']
    sound = _run(root, cell, seed, seconds=0.1)
    assert sound['correct'], sound['checks']


@pytest.mark.parametrize('cell, fault', [
    (cell, fault) for cell in tiny.PLAIN
    for fault in sorted(faults.FAULTS[_kind(cell)])])
def test_a_planted_fault_is_not_correct(root, cell, fault):
  result = _run(root, cell, SEEDS[0], plant=faults.plant(_kind(cell), fault))
  assert not result['correct'], result['checks']
  assert result['failed'] > 0


def test_a_run_undoes_its_patches(root):
  """The program's attributes are the originals after a run with a plant
  and the traced hooks, also after a run that fails."""
  from mt3_tpu_torch.infer import decode
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.train import adafactor
  before = (decode.decode_tokens, t5.decode_step, adafactor.Adafactor.step)
  lines = []
  driver.run(spec.Cell('tiny.bulk', root), SEEDS[0], 0.1, True,
             torch.device('cpu'), time.perf_counter(), out=lines.append,
             plant=faults.plant('bulk', 'token'))

  def broken(ctx):
    raise RuntimeError('a plant that fails')

  with pytest.raises(RuntimeError):
    driver.run(spec.Cell('tiny.train', root), SEEDS[0], 0.1, False,
               torch.device('cpu'), time.perf_counter(), out=lines.append,
               plant=lambda ctx: (faults.unchanged(ctx), broken(ctx)))
  assert (decode.decode_tokens, t5.decode_step,
          adafactor.Adafactor.step) == before
