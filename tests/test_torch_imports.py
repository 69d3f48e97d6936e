"""Rules of the PyTorch port that hold without a GPU.

* No module of mt3_tpu_torch, nor chip_smoke.py, imports jax, flax,
  msgpack or mt3_tpu.  Every module imports only torch, numpy, scipy, the
  standard library and the port itself, with two exceptions, each inside
  one function: tensorstore in train/checkpoint._read_tensorstore (orbax
  checkpoints), PIL in eval/summaries' pianoroll_image and save_png.
  chip_smoke.py alone may import the benchmark (gpubench), whose
  yardstick (gpubench/work.py) it reports against; the program never does.
* Entry points default to CUDA and raise when there is none.
* A kernel wrapper runs its plain version only for CPU tensors: any other
  tensor goes to the kernel, which raises when it cannot run.
"""

import ast
import pathlib
import sys

import numpy as np
import pytest
import torch

import mt3_tpu_torch
from mt3_tpu_torch import ops
from mt3_tpu_torch.core import config
from mt3_tpu_torch.infer import transcribe
from mt3_tpu_torch.ops import (cuda_build, decode_attention, flash_attention,
                               logmel)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / 'mt3_tpu_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py']


def _imported_modules(path):
  """(top-level module, enclosing function or None) of each import."""
  tree = ast.parse(path.read_text(), filename=str(path))
  functions = {}
  for node in ast.walk(tree):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
      for child in ast.walk(node):
        functions.setdefault(child, node.name)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names = [alias.name for alias in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      names = [node.module]
    else:
      continue
    for name in names:
      yield name.split('.')[0], functions.get(node)


FORBIDDEN = ('jax', 'jaxlib', 'mt3_tpu', 'flax', 'msgpack')
ALLOWED = {'torch', 'numpy', 'scipy', 'mt3_tpu_torch'}
# (module, function) -> the one optional package it may import.
LAZY = {('mt3_tpu_torch/train/checkpoint.py', '_read_tensorstore'):
            'tensorstore',
        ('mt3_tpu_torch/eval/summaries.py', 'pianoroll_image'): 'PIL',
        ('mt3_tpu_torch/eval/summaries.py', 'save_png'): 'PIL'}
# (module, package): the one module that may import the benchmark, anywhere.
BENCHMARK_READER = ('chip_smoke.py', 'gpubench')


def _violations(path, relative):
  """Imports of a forbidden package, or of a package outside torch, numpy,
  scipy and the standard library that LAZY or BENCHMARK_READER does not
  admit where it is."""
  return [(top, function) for top, function in _imported_modules(path)
          if top in FORBIDDEN or not (
              top in ALLOWED or top in sys.stdlib_module_names
              or LAZY.get((relative, function)) == top
              or (relative, top) == BENCHMARK_READER)]


@pytest.mark.parametrize('path', SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_mt3_tpu_imports(path):
  assert not _violations(path, str(path.relative_to(ROOT)))


@pytest.mark.parametrize('planted', (
    'import flax', 'import msgpack', 'from jax import numpy',
    'import tensorstore', 'import PIL',
    'def pianoroll_image():\n  import tensorstore',
    'def _read_tensorstore():\n  import msgpack', 'import gpubench'))
def test_import_scan_catches_planted_imports(tmp_path, planted):
  """A planted import fails the scan, in the place of either module that
  LAZY admits an optional package in; the benchmark, which chip_smoke.py
  may import, is caught in the program's modules."""
  for relative in LAZY:
    path = tmp_path / 'module.py'
    path.write_text(planted + '\n')
    assert _violations(path, relative[0]), (relative, planted)


@pytest.fixture
def no_cuda(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_entry_points_need_cuda_by_default(no_cuda):
  with pytest.raises(RuntimeError, match="device='cpu'"):
    mt3_tpu_torch.load_transcriber('tiny')
  with pytest.raises(RuntimeError, match="device='cpu'"):
    transcribe.Transcriber(config.tiny_config(), {})
  with pytest.raises(RuntimeError, match="device='cpu'"):
    mt3_tpu_torch.load_transcriber('tiny', device='cuda')
  from mt3_tpu_torch.cli import transcribe as cli
  with pytest.raises(RuntimeError, match="device='cpu'"):
    cli.main(['unused.wav', '--model', 'tiny'])
  from mt3_tpu_torch.cli import evaluate
  with pytest.raises(RuntimeError, match="device='cpu'"):
    evaluate.main(['--model', 'tiny'])
  assert mt3_tpu_torch.load_transcriber('tiny', device='cpu').device.type == (
      'cpu')


def test_training_entry_points_need_cuda_by_default(no_cuda):
  from mt3_tpu_torch.cli import train as cli
  from mt3_tpu_torch.train import trainer
  tiny = config.tiny_config()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    trainer.Trainer(tiny.model, tiny.run)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    trainer.init_train_state(tiny.model)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    cli.main(['--model', 'tiny', '--steps', '1'])
  assert trainer.Trainer(tiny.model, tiny.run,
                         device='cpu').device.type == 'cpu'
  state = trainer.init_train_state(tiny.model, device='cpu')
  assert {p.device.type for p in state.optimizer.param_groups[0]['params']
          } == {'cpu'}


def test_wrappers_do_not_fall_back_for_non_cpu_tensors():
  ops.reset_launches()
  meta = dict(device='meta')
  q = torch.empty(2, 6, 64, **meta)
  cache = torch.empty(2, 6, 64, 16, **meta)
  index = torch.empty((), dtype=torch.int32, **meta)
  with pytest.raises(ValueError, match='CUDA'):
    decode_attention.decode_attention_inplace(q, q, q, cache, cache, index)
  with pytest.raises(ValueError, match='CUDA'):
    logmel.logmel_fused(torch.empty(2, 4096, **meta), config.SpectrogramConfig())
  qkv = torch.empty(2, 6, 128, 64, **meta)
  with pytest.raises(ValueError, match='CUDA'):
    flash_attention.flash_attention(qkv, qkv, qkv, causal=True)
  assert not any(ops.launch_counts().values())


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
  monkeypatch.setenv('PATH', str(tmp_path))
  monkeypatch.setenv('CUDA_HOME', str(tmp_path))
  monkeypatch.setattr(cuda_build, 'BUILD_DIR', tmp_path / 'build')
  monkeypatch.setattr(cuda_build, '_LIBRARIES', {})
  with pytest.raises(RuntimeError, match='nvcc not found'):
    cuda_build.library('decode_attention')
  with pytest.raises(RuntimeError, match='nvcc not found'):
    cuda_build.build(['logmel', 'decode_attention', 'flash_attention',
                      'flash_attention_tc'])
  with pytest.raises(RuntimeError, match='nvcc not found'):
    cuda_build.library('flash_attention')
  with pytest.raises(RuntimeError, match='nvcc not found'):
    cuda_build.library('flash_attention_tc')


def test_library_paths_are_keyed_by_source():
  a = cuda_build.library_path('logmel')
  b = cuda_build.library_path('decode_attention')
  c = cuda_build.library_path('flash_attention')
  d = cuda_build.library_path('flash_attention_tc')
  assert len({a, b, c, d}) == 4
  assert a.parent == b.parent == c.parent == d.parent == cuda_build.BUILD_DIR
  assert a.name.startswith('liblogmel-') and a.suffix == '.so'


def test_library_paths_are_keyed_by_headers(monkeypatch, tmp_path):
  """An edited csrc/*.cuh (flash_attention.cuh, which both kernel C
  sources include) rebuilds the libraries."""
  for f in cuda_build.CSRC.iterdir():
    (tmp_path / f.name).write_bytes(f.read_bytes())
  monkeypatch.setattr(cuda_build, 'CSRC', tmp_path)
  before = cuda_build.library_path('flash_attention_tc')
  with open(tmp_path / 'flash_attention.cuh', 'a') as header:
    header.write('// edited\n')
  assert cuda_build.library_path('flash_attention_tc') != before


def test_plain_versions_do_not_count_launches():
  ops.reset_launches()
  x = torch.from_numpy(np.random.RandomState(0).randn(1, 1024).astype(
      np.float32))
  logmel.logmel_fused(x, config.SpectrogramConfig())
  q = torch.zeros(1, 2, 4)
  decode_attention.decode_attention_inplace(
      q, q, q, torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8),
      torch.tensor(3, dtype=torch.int32))
  q = torch.zeros(1, 2, 128, 64, requires_grad=True)
  flash_attention.flash_attention(q, q, q, causal=True).sum().backward()
  assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
