"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (mt3_tpu_torch is not mt3_tpu); the reference
imports nothing of the program; the command refuses to run where it
cannot measure."""

import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from gpubench import harness

REPO = pathlib.Path(__file__).resolve().parents[2]
SOURCES = sorted((REPO / 'gpubench').rglob('*.py'))


def _imports(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
  assert harness.forbidden_modules(list(_imports(path))) == []


@pytest.mark.parametrize('path', sorted(
    (REPO / 'gpubench' / 'reference').glob('*.py')), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
  for name in _imports(path):
    top = name.split('.')[0]
    assert top in {'__future__', 'functools', 'math', 'numpy', 'torch'} or (
        name.startswith('gpubench.reference')), name


def test_a_run_loads_no_jax(tmp_path):
  """A whole run of a tiny cell, in a fresh process, ends with neither
  jax, jaxlib, flax nor mt3_tpu in sys.modules."""
  code = f"""
import sys, time, pathlib, torch
sys.path.insert(0, {str(REPO)!r})
from gpubench import driver, harness, spec
from gpubench.tests import tiny
root = tiny.make_root(pathlib.Path({str(tmp_path)!r}))
driver.run(spec.Cell('tiny.clip', root), 5, 0.1, True, torch.device('cpu'),
           time.perf_counter(), out=lambda line: None)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300, check=True).stdout
  loaded = json.loads(out.strip().splitlines()[-1].replace("'", '"'))
  assert 'mt3_tpu_torch' in loaded
  assert harness.forbidden_modules(loaded) == []


def _command(cwd):
  bench = json.loads((REPO / 'BENCHMARK.json').read_text())
  cell = bench['workloads'][0]['name']
  return subprocess.run(
      [sys.executable, *bench['command'][1:], '--workload', cell, '--seed',
       '2147483659', '--seconds', '1', '--trace', '0'],
      cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_prints_no_result_without_a_card():
  import torch
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present')
  done = _command(REPO)
  assert done.returncode != 0 and done.stdout == ''


def test_the_command_prints_no_result_without_the_program(tmp_path):
  shutil.copy(REPO / 'BENCHMARK.json', tmp_path)
  shutil.copytree(REPO / 'gpubench', tmp_path / 'gpubench')
  done = _command(tmp_path)
  assert done.returncode != 0 and done.stdout == ''
