"""The port's measurement scripts (mt3_tpu_torch/tools/run_mixing_probe.sh,
run_r5_queue.sh, run_r5_extras.sh) against the JAX package's, on the CPU.

Each names the port's modules and none of mt3_tpu's; the mixing probe
runs the port's train CLI with the JAX script's flags; the queue and the
extras run through bash with PYTHON set to a recorder, which keeps each
step's argv and exits 0 (or 3 for one chosen step): the queue's step /
done-marker / queue.log mechanics hold, and every argv the scripts pass
parses with its port tool's own parser.
"""

import importlib
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from mt3_tpu_torch.cli import train as train_cli
from tests.test_torch_tools import _expand, _flags

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOLS = ROOT / 'mt3_tpu_torch' / 'tools'
SCRIPTS = ('run_mixing_probe.sh', 'run_r5_queue.sh', 'run_r5_extras.sh')

RECORDER = '''
import json, os, sys
argv = sys.argv[1:]
with open(os.environ['RECORD'], 'a') as f:
  f.write(json.dumps(argv) + '\\n')
fail = os.environ.get('FAIL')
sys.exit(3 if fail and fail in ' '.join(argv) else 0)
'''


@pytest.mark.parametrize('name', SCRIPTS)
def test_script_names_the_port_and_its_own_root(name):
  text = (TOOLS / name).read_text()
  assert 'mt3_tpu_torch.' in text
  assert not re.search(r'mt3_tpu\.', text), name
  assert not re.search(r'python\S* (tools/|bench\.py)', text), name
  assert not re.search(r'^cd /', text, re.M), name
  assert 'cd "$(dirname "$0")/../.." || exit 1' in text
  assert re.search(r'^RUN=\$\{RUN:-runs/\w+_torch\}$', text, re.M), name
  assert os.access(TOOLS / name, os.X_OK)
  if name != 'run_mixing_probe.sh':
    assert 'health probes' in text or 'health concerns' in text


def _train_command(path):
  """(module, argv) of the train CLI command of a probe script, with its
  variables at their defaults."""
  text = path.read_text()
  values = {}
  for var, value in re.findall(r'^(\w+)=(\S+)$', text, re.M):
    default = re.fullmatch(r'\$\{%s:-(.*)\}' % var, value)
    values[var] = _expand(default.group(1) if default else value, values)
  command = re.search(r'-m (\S+\.cli\.train) (.*?)>>', text, re.S)
  tokens = command.group(2).replace('\\\n', ' ').replace('"', '').split()
  return command.group(1), [_expand(t, values) for t in tokens]


def test_mixing_probe_has_the_jax_scripts_flags():
  module, argv = _train_command(TOOLS / 'run_mixing_probe.sh')
  jax_module, jax_argv = _train_command(ROOT / 'tools' /
                                        'run_mixing_probe.sh')
  assert (module, jax_module) == ('mt3_tpu_torch.cli.train',
                                  'mt3_tpu.cli.train')
  args = train_cli.build_parser().parse_args(argv)
  assert args.max_examples_per_mix == 8 and args.batch_size == 256
  assert args.remat and args.bf16 and args.attention == 'flash'
  assert _flags([a.replace('_torch/', '/') for a in argv]) == _flags(
      jax_argv)


@pytest.fixture
def recorder(tmp_path):
  (tmp_path / 'recorder.py').write_text(RECORDER)
  python = tmp_path / 'python'
  python.write_text(f'#!/bin/bash\nexec {sys.executable} '
                    f'{tmp_path / "recorder.py"} "$@"\n')
  python.chmod(0o755)
  return python


def _run(script, recorder, tmp_path, **env):
  proc = subprocess.run(
      ['bash', str(TOOLS / script)], capture_output=True, text=True,
      timeout=120,
      env={**os.environ, 'PYTHON': str(recorder),
           'RECORD': str(tmp_path / 'argv.jsonl'), **env})
  return proc


def _recorded(tmp_path):
  path = tmp_path / 'argv.jsonl'
  return ([json.loads(l) for l in path.read_text().splitlines()]
          if path.exists() else [])


def _parses(argv):
  """argv (`-m module args`) parses with the module's own parser."""
  assert argv[0] == '-m', argv
  module = importlib.import_module(argv[1])
  return module.build_parser().parse_args(argv[2:])


def test_queue_steps_markers_and_log(recorder, tmp_path):
  run = tmp_path / 'r5'
  proc = _run('run_r5_queue.sh', recorder, tmp_path, RUN=str(run),
              FAIL='--variant int4_cross --batch 256 --num_beams 4')
  assert proc.returncode == 0, proc.stderr
  steps = ['trained_bench', 'bw_profile', 'bw_fit', 'bw_patterns',
           'beam_g8', 'beam2_8', 'beam4_8', 'mixing', 'beam2_4', 'beam4_4']
  log = (run / 'queue.log').read_text()
  assert re.findall(r'START (\w+):', log) == steps
  assert re.findall(r'END (\w+) rc=(\d+)', log) == [
      (s, '3' if s == 'beam4_4' else '0') for s in steps]
  assert log.rstrip().endswith('QUEUE COMPLETE')
  assert sorted(p.name for p in run.glob('done.*')) == sorted(
      f'done.{s}' for s in steps if s != 'beam4_4')
  recorded = _recorded(tmp_path)
  assert len(recorded) == len(steps)
  modules = [argv[1] for argv in recorded]
  assert modules == [
      'mt3_tpu_torch.bench', 'mt3_tpu_torch.tools.perf_experiments',
      'mt3_tpu_torch.tools.bucket_fit', 'mt3_tpu_torch.tools.cache_bw_bench',
      *['mt3_tpu_torch.tools.perf_experiments'] * 3,
      'mt3_tpu_torch.cli.train',
      *['mt3_tpu_torch.tools.perf_experiments'] * 2]
  for argv in recorded:
    if argv[1] == 'mt3_tpu_torch.cli.train':
      args = train_cli.build_parser().parse_args(argv[2:])
      assert args.checkpoint_dir == f'{run}/mixing_probe/ckpt'
    else:
      _parses(argv)
  profile = _parses(recorded[1]).profile
  assert _parses(recorded[2]).profile_dir == profile == f'{run}/prof'

  # A second run skips every step that left its marker.
  proc = _run('run_r5_queue.sh', recorder, tmp_path, RUN=str(run))
  assert proc.returncode == 0
  log = (run / 'queue.log').read_text()
  assert log.count('SKIP') == len(steps) - 1
  assert _recorded(tmp_path)[-1][1:5] == [
      'mt3_tpu_torch.tools.perf_experiments', '--variant', 'int4_cross',
      '--batch']


def test_extras_wait_for_the_queue_then_run(recorder, tmp_path):
  run = tmp_path / 'r5'
  proc = _run('run_r5_extras.sh', recorder, tmp_path, RUN=str(run),
              WAIT_MINUTES='0')
  assert proc.returncode == 1
  assert 'main queue never completed' in (run / 'queue.log').read_text()
  assert not _recorded(tmp_path)

  (run / 'queue.log').write_text('QUEUE COMPLETE\n')
  proc = _run('run_r5_extras.sh', recorder, tmp_path, RUN=str(run))
  assert proc.returncode == 0, proc.stderr
  recorded = _recorded(tmp_path)
  assert [argv[1] for argv in recorded] == [
      'mt3_tpu_torch.tools.train_bench', 'mt3_tpu_torch.tools.train_bench',
      'mt3_tpu_torch.bench']
  i21_xla, i21_flash, _ = (_parses(argv) for argv in recorded)
  assert (i21_xla.model, i21_xla.batch, i21_xla.flash) == (
      'ismir2021', 64, False)
  assert i21_flash.flash and i21_flash.remat and i21_flash.bf16
  assert (run / 'queue.log').read_text().rstrip().endswith(
      'EXTRAS COMPLETE')
