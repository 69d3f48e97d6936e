"""Build and load the hand-written CUDA kernels of mt3_tpu_torch.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds).  Libraries land in a build directory keyed by a hash of the
source, the headers beside it (`csrc/*.cuh`) and the flags, so an edited
source or header rebuilds and an unchanged one is reused.  The build runs at first use; `build()` compiles several sources
concurrently (one nvcc each).

There is no fallback: a kernel that cannot be built raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Sequence

CSRC = pathlib.Path(__file__).resolve().parents[1] / 'csrc'
# <repo>/build/kernels unless MT3_TORCH_BUILD_DIR says otherwise.
BUILD_DIR = pathlib.Path(os.environ.get(
    'MT3_TORCH_BUILD_DIR',
    pathlib.Path(__file__).resolve().parents[2] / 'build' / 'kernels'))
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LIBRARIES: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, nvcc's stderr, which holds the -Xptxas -v report).
BUILD_LOGS: Dict[str, tuple] = {}


def _nvcc() -> str:
  cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
  for candidate in (shutil.which('nvcc'),
                    os.path.join(cuda_home, 'bin', 'nvcc')):
    if candidate and os.path.exists(candidate):
      return candidate
  raise RuntimeError(
      'nvcc not found: the CUDA kernels of mt3_tpu_torch are compiled from '
      f'{CSRC} at first use and need the CUDA toolkit (set CUDA_HOME)')


def library_path(name: str) -> pathlib.Path:
  digest = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
  for header in sorted(CSRC.glob('*.cuh')):
    digest.update(header.read_bytes())
  digest.update(' '.join(NVCC_FLAGS).encode())
  return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build(names: Sequence[str]) -> Dict[str, pathlib.Path]:
  """Compile the named sources that are not built yet, all at once."""
  paths = {name: library_path(name) for name in names}
  todo = [name for name in names if not paths[name].exists()]
  if not todo:
    return paths
  nvcc = _nvcc()
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  start = time.perf_counter()
  procs = {}
  for name in todo:
    tmp = paths[name].with_suffix(f'.{os.getpid()}.tmp')
    cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    procs[name] = (tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
  failures = []
  for name, (tmp, proc) in procs.items():
    out, err = proc.communicate()
    BUILD_LOGS[name] = (time.perf_counter() - start, out + err)
    if proc.returncode != 0:
      failures.append(f'{name}.cu (exit {proc.returncode}):\n{out}{err}')
    else:
      os.replace(tmp, paths[name])
  if failures:
    raise RuntimeError('nvcc failed for ' + '\n'.join(failures))
  return paths


def library(name: str) -> ctypes.CDLL:
  """The loaded library for csrc/<name>.cu, built first if needed."""
  if name not in _LIBRARIES:
    path = build([name])[name]
    lib = ctypes.CDLL(str(path))
    lib.mt3_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mt3_cuda_error_string.restype = ctypes.c_char_p
    _LIBRARIES[name] = lib
  return _LIBRARIES[name]


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
  """Raise on a non-zero cudaError_t returned by a C entry point."""
  if status != 0:
    message = lib.mt3_cuda_error_string(status).decode()
    raise RuntimeError(f'{what}: CUDA error {status} ({message}) at launch')
