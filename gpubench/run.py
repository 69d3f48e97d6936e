"""The benchmark of mt3_tpu_torch: one run of one cell.

  python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell from BENCHMARK.json, draws its parameters and inputs from
the seed, warms up the cell's own shapes, measures for `--seconds`
seconds, compares what the window produced with the plain reference
(gpubench/reference/) and prints one JSON line last on standard output.
With --trace 0 it reports the cell's end-to-end metrics; with --trace 1
its per-layer metrics, read from profiler sessions and spans over a short
steady part of the window.  Each number compared is printed beside its
limit, last on standard error and under "checks" in the result line.

It exits non-zero and prints no result when there is no CUDA device (or
fewer than the cell asks for), when the program cannot be imported, and
when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / 'gpubench'


def _environment():
  """Import paths and the program's build and kernel caches, all at fixed
  paths inside the checkout, so that only a checkout's first run builds."""
  sys.path[:] = [p for p in sys.path
                 if pathlib.Path(p or '.').resolve() != HERE]
  sys.path.insert(0, str(ROOT))
  cache = ROOT / 'build'
  os.environ['MT3_TORCH_BUILD_DIR'] = str(cache / 'kernels')
  os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
  os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
  os.environ['CUDA_CACHE_PATH'] = str(cache / 'cuda_cache')
  os.environ['USE_FLAX'] = '0'
  os.environ.setdefault('OMP_NUM_THREADS', '4')


def parse(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seed', type=int, required=True)
  p.add_argument('--seconds', type=float, required=True)
  p.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return p.parse_args(argv)


def main(argv=None) -> int:
  _environment()
  args = parse(argv)
  from gpubench import harness
  try:
    import torch
  except ImportError as e:
    harness.log(f'gpubench: cannot import torch: {e}')
    return 2
  marks = [('torch import', time.perf_counter())]
  from gpubench import spec
  cell = spec.Cell(args.workload, ROOT)
  if not torch.cuda.is_available() or (torch.cuda.device_count()
                                       < cell.chips):
    harness.log(f'gpubench: {cell.name} needs {cell.chips} CUDA device(s); '
                f'found {torch.cuda.device_count() if torch.cuda.is_available() else 0}')
    return 3
  try:
    import mt3_tpu_torch  # noqa: F401
  except ImportError as e:
    harness.log(f'gpubench: cannot import the program mt3_tpu_torch: {e}')
    return 4
  marks.append(('program import', time.perf_counter()))
  torch.empty(1, device='cuda')
  marks.append(('CUDA init', time.perf_counter()))
  from gpubench import driver
  return driver.run(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device('cuda', 0), START, marks=marks)


if __name__ == '__main__':
  sys.exit(main())
