"""The port's workflow tools against the JAX package's, on the CPU.

mt3_tpu_torch/tools/make_corpus writes the bytes tools/make_corpus.py
writes; mt3_tpu_torch/tools/training_report prints what
tools/training_report.py prints for a run of the port's train CLI, whose
step lines its STEP_RE reads; each recipe under mt3_tpu_torch/tools/ runs
the port's train CLI with flags that its parser takes and that equal the
JAX recipe's; the port's quickstart has examples/quickstart.py's
configuration and first batch, and writes its outputs.  The JAX tools are
loaded from their files; nothing under tools/ or examples/ is edited.
"""

import ast
import contextlib
import io
import os
import pathlib
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch

from mt3_tpu.codec import vocabulary as jax_vocabulary
from mt3_tpu.core import config as jax_config
from mt3_tpu.data import datasets as jax_datasets
from mt3_tpu.data import pipeline as jax_pipeline
from mt3_tpu_torch.cli import train as train_cli
from mt3_tpu_torch.examples import quickstart
from mt3_tpu_torch.tools import make_corpus, training_report
from tests.test_torch_quality_gates import load_jax_tool

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The training recipes; the measurement scripts (run_mixing_probe.sh,
# run_r5_queue.sh, run_r5_extras.sh) are held by
# tests/test_torch_measure_scripts.py.
RECIPES = [ROOT / 'mt3_tpu_torch' / 'tools' / name
           for name in ('run_flagship.sh', 'run_gqa_ft.sh',
                        'run_ismir2021.sh')]


CORPUS_ARGV = ['--num', '3', '--num_validation', '1', '--num_test', '1',
               '--duration', '2.048']
# One program in the pool: one instrument a clip (see the next test).
PIANO_ARGV = ['--programs', '0', '--max_instruments', '1',
              '--velocity_bins', '127', '--no_ties']


@pytest.mark.parametrize('flavour', [[], PIANO_ARGV],
                         ids=['mt3', 'ismir2021'])
def test_make_corpus_writes_the_jax_tools_bytes(tmp_path, flavour):
  load_jax_tool('tools/make_corpus.py').main(
      ['--out', str(tmp_path / 'jax')] + CORPUS_ARGV + flavour)
  make_corpus.main(['--out', str(tmp_path / 'port')] + CORPUS_ARGV + flavour)

  def files(root):
    return sorted(p.relative_to(root) for p in root.rglob('*') if p.is_file())
  want = files(tmp_path / 'jax')
  assert files(tmp_path / 'port') == want
  assert sorted(p.suffix for p in want) == [
      '.mid', '.mid', '.tfrecord', '.wav', '.wav']
  for relative in want:
    assert ((tmp_path / 'port' / relative).read_bytes()
            == (tmp_path / 'jax' / relative).read_bytes()), relative


def test_make_corpus_one_program_needs_one_instrument(tmp_path):
  """With --programs 0 alone, the default --max_instruments 4 asks a clip
  for more distinct programs than the pool holds: both tools raise the
  same error."""
  argv = CORPUS_ARGV + ['--programs', '0', '--velocity_bins', '127',
                        '--no_ties']
  errors = []
  for name, main in (('jax', load_jax_tool('tools/make_corpus.py').main),
                     ('port', make_corpus.main)):
    with pytest.raises(ValueError) as error:
      main(['--out', str(tmp_path / name)] + argv)
    errors.append(str(error.value))
  assert errors[0] == errors[1] and 'larger sample' in errors[0]


@pytest.fixture(scope='module')
def cli_run(tmp_path_factory):
  """A run directory as a recipe leaves it: the stderr of the port's train
  CLI (tiny, 2 steps on the CPU, an evaluation at step 2) in train.log,
  its metrics.jsonl under logs/."""
  run = tmp_path_factory.mktemp('run')
  err = io.StringIO()
  with contextlib.redirect_stderr(err):
    train_cli.main(['--model', 'tiny', '--steps', '2', '--batch_size', '2',
                    '--device', 'cpu', '--log_every', '1', '--eval_period',
                    '2', '--eval_examples', '1', '--log_dir',
                    str(run / 'logs')])
  (run / 'train.log').write_text(err.getvalue())
  return run


def test_step_re_reads_the_port_train_cli(cli_run):
  jax_tool = load_jax_tool('tools/training_report.py')
  lines = [l for l in (cli_run / 'train.log').read_text().splitlines()
           if l.startswith('step ')]
  assert len(lines) == 2
  for line in lines:
    assert training_report.STEP_RE.match(line.strip()), line
    assert jax_tool.STEP_RE.match(line.strip()), line
  rows = training_report.parse_train_log(str(cli_run / 'train.log'))
  assert sorted(rows) == [0, 1]
  assert all(np.isfinite(v).all() for v in rows.values())


@pytest.mark.parametrize('every', ['500', '1'])
def test_training_report_prints_the_jax_report(cli_run, capsys, monkeypatch,
                                               every):
  argv = ['--run', str(cli_run), '--every', every]
  monkeypatch.setattr(sys, 'argv', ['training_report.py'] + argv)
  load_jax_tool('tools/training_report.py').main()
  want = capsys.readouterr().out
  training_report.main(argv)
  got = capsys.readouterr().out
  assert got == want
  assert '| 0 |' in got and '| 1 |' in got and '| 2 |' in got, got


def _defaults(text):
  """The recipe's variables: `X=${X:-default}` and plain assignments."""
  values = {}
  for name, value in re.findall(r'^(\w+)=(\S+)$', text, re.M):
    default = re.fullmatch(r'\$\{%s:-(.*)\}' % name, value)
    values[name] = _expand(default.group(1) if default else value, values)
  return values


def _expand(token, values):
  return re.sub(r'\$\{?(\w+)\}?', lambda m: values.get(m.group(1),
                                                       m.group(0)), token)


def recipe_argv(path):
  """(train module, argv) of the train command in a recipe, with its
  variables at their defaults."""
  text = path.read_text()
  values = _defaults(text)
  command = re.search(r'-m (\S+\.cli\.train) (.*?)>> "?\$LOG"?', text,
                      re.S)
  tokens = shlex.split(command.group(2).replace('\\\n', ' '))
  return command.group(1), [_expand(t, values) for t in tokens], values


def _flags(argv):
  out, i = {}, 0
  while i < len(argv):
    if i + 1 < len(argv) and not argv[i + 1].startswith('--'):
      out[argv[i]] = argv[i + 1]
      i += 2
    else:
      out[argv[i]] = True
      i += 1
  return out


def test_every_jax_recipe_has_its_port():
  def names(directory):
    return sorted(p.name for p in (ROOT / directory).glob('run_*.sh'))
  assert names('mt3_tpu_torch/tools') == names('tools')
  assert all(p.exists() for p in RECIPES)


@pytest.mark.parametrize('path', RECIPES, ids=[p.name for p in RECIPES])
def test_recipe_runs_the_port_cli_with_the_jax_flags(path):
  text = path.read_text()
  assert 'mt3_tpu_torch.cli.train' in text
  assert 'mt3_tpu.' not in text
  # The repository root comes from the script's own path.
  assert not re.search(r'^cd /', text, re.M), path
  module, argv, values = recipe_argv(path)
  assert module == 'mt3_tpu_torch.cli.train'
  args = train_cli.build_parser().parse_args(argv)
  assert args.resume and args.exit_rss_gb == 70 and args.steps > 0
  # The JAX recipe's flags and values, but for the runs under runs/ (which
  # git tracks for the JAX package): the port's end in '_torch'.
  jax_module, jax_argv, jax_values = recipe_argv(ROOT / 'tools' / path.name)
  assert jax_module == 'mt3_tpu.cli.train'
  assert values['RUN'] == jax_values['RUN'] + '_torch'
  runs = [a for a in argv if a.startswith('runs/')]
  assert runs and all(re.match(r'runs/\w+_torch/', a) for a in runs), runs
  assert _flags([a.replace('_torch/', '/') for a in argv]) == _flags(jax_argv)


def test_ismir2021_recipe_refuses_without_a_cache(tmp_path):
  script = ROOT / 'mt3_tpu_torch' / 'tools' / 'run_ismir2021.sh'
  proc = subprocess.run(
      ['bash', str(script)], capture_output=True, text=True, timeout=60,
      env={**{k: os.environ[k] for k in ('HOME', 'TMPDIR')
              if k in os.environ},
           'PATH': '/usr/bin:/bin', 'CORPUS': str(tmp_path / 'none'),
           'RUN': str(tmp_path / 'run')})
  assert proc.returncode == 1
  assert 'cache is empty' in proc.stdout and '--max_instruments 1' in (
      proc.stdout)
  assert not (tmp_path / 'run').exists()


def test_quickstart_is_the_examples_recipe():
  """The port's quickstart configuration equals the literals of
  examples/quickstart.py, and its first batch the JAX pipeline's."""
  tree = ast.parse((ROOT / 'examples' / 'quickstart.py').read_text())
  literals = {}
  for node in ast.walk(tree):
    if isinstance(node, ast.Call) and isinstance(
        node.func, (ast.Name, ast.Attribute)):
      name = getattr(node.func, 'id', getattr(node.func, 'attr', None))
      literals[name] = {k.arg: ast.literal_eval(k.value)
                        for k in node.keywords
                        if isinstance(k.value, ast.Constant)}
  cfg = quickstart.config()
  for name, fields in (('ModelConfig', cfg.model), ('RunConfig', cfg.run),
                       ('VocabularyConfig', cfg.vocab)):
    assert literals[name], name
    for key, value in literals[name].items():
      assert getattr(fields, key) == value, (name, key)
  source = literals['SyntheticDataSource']
  steps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
           and getattr(n.func, 'id', None) == 'range']
  assert [ast.literal_eval(n.args[0]) for n in steps] == [quickstart.STEPS]

  jax_example = next(jax_datasets.SyntheticDataSource(**source).examples())
  clip = quickstart.example()
  np.testing.assert_array_equal(clip['audio'], jax_example['audio'])
  codec = jax_vocabulary.build_codec(jax_config.VocabularyConfig(
      num_velocity_bins=1))
  vocab = jax_vocabulary.vocabulary_from_codec(codec)
  assert cfg.model.vocab_size == jax_vocabulary.num_embeddings(vocab)
  want = next(jax_pipeline.train_batches(
      [jax_example], jax_config.SpectrogramConfig(), codec, vocab,
      jax_pipeline.TrainPipelineConfig(inputs_length=256, targets_length=160,
                                       batch_size=4)))
  got = quickstart.first_batch(cfg, clip)
  assert sorted(got) == sorted(want)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_quickstart_main_writes_its_outputs(tmp_path, monkeypatch, capsys):
  train = quickstart.train
  monkeypatch.setattr(quickstart, 'train',
                      lambda device: train(device, steps=2))
  quickstart.main(str(tmp_path), 'cpu')
  out = capsys.readouterr().out
  assert re.search(r'\d+ notes; onset F1 = \d\.\d{3}', out), out
  for name in ('input.wav', 'transcribed.mid', 'resynth.wav',
               'pianoroll.png'):
    assert (tmp_path / name).stat().st_size > 0, name


def test_quickstart_needs_cuda_by_default(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    quickstart.train()


def test_console_scripts_name_the_port_clis():
  import importlib
  import tomllib
  scripts = tomllib.loads((ROOT / 'pyproject.toml').read_text())[
      'project']['scripts']
  port = {k: v for k, v in scripts.items() if k.startswith('mt3-torch-')}
  assert sorted(port) == ['mt3-torch-evaluate', 'mt3-torch-train',
                          'mt3-torch-transcribe']
  for name, target in port.items():
    module, function = target.split(':')
    assert module == 'mt3_tpu_torch.cli.' + name.split('-')[-1]
    assert callable(getattr(importlib.import_module(module), function))
