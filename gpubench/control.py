"""Whole runs of a cell with a fault or the control planted, over many
seeds, for setting and proving its limits.

  python3 gpubench/control.py --workload <cell> --seeds 1,2,3 --seconds 5
      [--plant control|<fault>]

For each seed, in one process: a whole run of the cell (set-up, a window
of `--seconds`, at least one unit, and the comparison with the
reference), with the plant of gpubench/faults.py underneath the timed
path, or none (sound runs: the lower readings).  It prints one JSON line
a seed: `correct` and each number compared beside its limit, as the run's
result line has them.  With --plant control the reference in the next
lower precision stands in the program's place: its numbers are the upper
readings, and `correct` has to read false.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as entry  # gpubench/run.py, beside this file


def main(argv=None, root=None) -> int:
  entry._environment()
  p = argparse.ArgumentParser()
  p.add_argument('--workload', required=True)
  p.add_argument('--seeds', required=True)
  p.add_argument('--seconds', type=float, default=0.0)
  p.add_argument('--plant', default=None)
  p.add_argument('--device', default='cuda')
  args = p.parse_args(argv)
  import torch
  from gpubench import driver, faults, spec
  cell = spec.Cell(args.workload, root or entry.ROOT)
  plant = faults.plant(cell.traffic['kind'], args.plant) if args.plant else None
  for seed in (int(s) for s in args.seeds.split(',')):
    start = time.perf_counter()
    lines = []
    driver.run(cell, seed, args.seconds, False, torch.device(args.device),
               start, out=lines.append, plant=plant)
    result = json.loads(lines[-1])
    if args.device != 'cpu':
      torch.cuda.empty_cache()
    print(json.dumps(dict(
        workload=cell.name, seed=seed, plant=args.plant,
        seconds=time.perf_counter() - start, correct=result['correct'],
        checks=result['checks'])), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
