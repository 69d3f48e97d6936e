"""Rules of the PyTorch port that hold without a GPU.

* No module of mt3_tpu_torch, nor chip_smoke.py, imports jax or mt3_tpu.
* Entry points default to CUDA and raise when there is none.
* A kernel wrapper runs its plain version only for CPU tensors: any other
  tensor goes to the kernel, which raises when it cannot run.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import mt3_tpu_torch
from mt3_tpu_torch.core import config
from mt3_tpu_torch.infer import transcribe
from mt3_tpu_torch.ops import (cuda_build, decode_attention, flash_attention,
                               logmel)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / 'mt3_tpu_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py']


def _imported_modules(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module


@pytest.mark.parametrize('path', SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_mt3_tpu_imports(path):
  for name in _imported_modules(path):
    top = name.split('.')[0]
    assert top not in ('jax', 'jaxlib', 'mt3_tpu', 'flax'), (path, name)


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
  assert decode_attention.LAUNCHES == 0 and logmel.LAUNCHES == 0
  assert set(flash_attention.LAUNCHES.values()) == {0}


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
  x = torch.from_numpy(np.random.RandomState(0).randn(1, 1024).astype(
      np.float32))
  logmel.logmel_fused(x, config.SpectrogramConfig())
  q = torch.zeros(1, 2, 4)
  decode_attention.decode_attention_inplace(
      q, q, q, torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8),
      torch.tensor(3, dtype=torch.int32))
  q = torch.zeros(1, 2, 128, 64, requires_grad=True)
  flash_attention.flash_attention(q, q, q, causal=True).sum().backward()
  assert decode_attention.LAUNCHES == 0 and logmel.LAUNCHES == 0
  assert set(flash_attention.LAUNCHES.values()) == {0}
