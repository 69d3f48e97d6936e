"""mt3_tpu_torch.tools.train_bench against tools/train_bench.py, on the CPU.

The same parser (flags, defaults, choices; the port adds --device), the
same parameter count for mt3 and ismir2021 (so the same FLOP model), the
same printed lines, and at tiny width the same first-step loss as JAX's
Trainer.step on the same batch from the same initial state, within the
train tests' metric tolerance (rtol 1e-5, tests/test_torch_train.py).
The JAX tool is loaded from its file; nothing in it is edited.
"""

import argparse
import re
import sys

import jax
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu.train import trainer as jax_trainer
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.tools import train_bench
from mt3_tpu_torch.train import trainer
from tests.test_torch_quality_gates import load_jax_tool
from tests.test_torch_train import _numpy_state

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def jax_tool():
  return load_jax_tool('tools/train_bench.py')


class _Parsed(Exception):
  pass


def jax_parser(tool, monkeypatch):
  """The ArgumentParser the JAX tool's main() builds (stopped when it
  parses)."""
  def stop(self, *args, **kwargs):
    raise _Parsed(self)
  monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', stop)
  with pytest.raises(_Parsed) as parsed:
    tool.main()
  monkeypatch.undo()
  return parsed.value.args[0]


def actions(parser, skip=()):
  return [(a.option_strings, a.dest, a.default, a.choices, a.type, a.nargs,
           a.const, type(a).__name__) for a in parser._actions
          if a.dest not in ('help',) + tuple(skip)]


def test_parser_is_the_jax_tools(jax_tool, monkeypatch):
  want = actions(jax_parser(jax_tool, monkeypatch))
  assert actions(train_bench.build_parser(), skip=('device',)) == want
  assert len(want) == 9


@pytest.mark.parametrize('model', ['mt3', 'ismir2021'])
def test_parameter_count_is_jax_s(model):
  jax_model = jax_config.CONFIG_FACTORIES[model]().model
  shapes = jax.eval_shape(
      lambda: jax_t5.init_params(jax.random.PRNGKey(0), jax_model)[0])
  want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
  got = train_bench.count_params(params_lib.init_params(
      torch_config.CONFIG_FACTORIES[model]().model))
  assert got == want
  assert got > 4e7


def _template(line):
  return re.sub(r'[0-9]+(\.[0-9]+)?', '#', line)


def test_one_cpu_step_matches_jax_trainer(jax_tool, monkeypatch, capsys):
  """--iters 1 at tiny width: both tools' printed lines have the same
  form, and the port's first step (from JAX's initial state, on the same
  numpy-seeded batch) has JAX's loss."""
  monkeypatch.setattr(jax_config, 'mt3_config', jax_config.tiny_config)
  monkeypatch.setattr(torch_config, 'mt3_config', torch_config.tiny_config)
  argv = ['--batch', '2', '--iters', '1']
  seen = {'jax': [], 'port': []}
  jax_step = jax_trainer.Trainer.step

  def record_jax(self, batch):
    if not seen['jax']:
      seen['initial'] = _numpy_state(self.state)
    metrics = jax_step(self, batch)
    seen['jax'].append({k: float(v) for k, v in metrics.items()})
    return metrics

  monkeypatch.setattr(jax_trainer.Trainer, 'step', record_jax)
  monkeypatch.setattr(sys, 'argv', ['train_bench.py'] + argv)
  jax_tool.main()
  want = capsys.readouterr().out.strip().splitlines()

  port_step = trainer.Trainer.step

  def record_port(self, batch):
    if not seen['port']:
      trainer.load_state_tree(self.state, seen['initial'])
    metrics = port_step(self, batch)
    seen['port'].append({k: float(v) for k, v in metrics.items()})
    return metrics

  monkeypatch.setattr(trainer.Trainer, 'step', record_port)
  train_bench.main(argv + ['--device', 'cpu'])
  got = capsys.readouterr().out.strip().splitlines()
  assert got[0].startswith('device: cpu')
  assert [_template(l) for l in got[1:]] == [_template(l) for l in want]
  assert len(seen['jax']) == len(seen['port']) == 2
  first_jax, first_port = seen['jax'][0], seen['port'][0]
  assert set(first_port) == set(first_jax)
  for key in ('loss', 'z_loss', 'accuracy'):
    np.testing.assert_allclose(first_port[key], first_jax[key], rtol=1e-5,
                               err_msg=key)


def test_profile_writes_a_trace(monkeypatch, tmp_path, capsys):
  monkeypatch.setattr(torch_config, 'mt3_config', torch_config.tiny_config)
  train_bench.main(['--batch', '2', '--iters', '1', '--no_dropout',
                    '--profile', str(tmp_path), '--device', 'cpu'])
  assert capsys.readouterr().out.strip().endswith(
      f'trace written to {tmp_path}')
  traces = list(tmp_path.glob('trace.*.json'))
  assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_raises_without_cuda():
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present')
  with pytest.raises(RuntimeError, match='CUDA'):
    train_bench.main(['--iters', '1'])
