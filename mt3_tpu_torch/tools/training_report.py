"""Render the flagship training curve (TRAINING.md tables) from run logs
(port of tools/training_report.py; the same output for the same run).

Reads the train CLI's log (its step/loss/acc lines, which a recipe under
mt3_tpu_torch/tools/ appends to <run>/train.log) and the evaluator's
metrics.jsonl (full metric family per eval step) and prints a markdown
report: a loss/accuracy curve table downsampled to --every steps and the
held-out eval trajectory (onset F1, onset+offset F1, frame F1).  Host only.

Usage:
  python -m mt3_tpu_torch.tools.training_report \
      --run runs/mt3_flagship_torch [--every 500]
"""

from __future__ import annotations

import argparse
import json
import os
import re

# mt3_tpu_torch/cli/train.py's step line.
STEP_RE = re.compile(
    r'step (\d+): loss=([\d.]+) acc=([\d.]+) lr=\S+ \(([\d.]+) steps/s\)')


def parse_train_log(path: str):
  rows = {}
  with open(path) as f:
    for line in f:
      m = STEP_RE.match(line.strip())
      if m:
        step = int(m.group(1))
        rows[step] = (float(m.group(2)), float(m.group(3)),
                      float(m.group(4)))
  return rows


def parse_metrics(path: str):
  rows = {}
  if not os.path.exists(path):
    return rows
  with open(path) as f:
    for line in f:
      try:
        d = json.loads(line)
      except json.JSONDecodeError:
        continue
      rows[int(d['step'])] = d
  return rows


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument('--run', default='runs/mt3_flagship_torch')
  p.add_argument('--every', type=int, default=500)
  args = p.parse_args(argv)

  train = parse_train_log(os.path.join(args.run, 'train.log'))
  evals = parse_metrics(os.path.join(args.run, 'logs', 'metrics.jsonl'))

  print('### Training curve\n')
  print('| step | loss | token acc | steps/s |')
  print('|---|---|---|---|')
  steps = sorted(train)
  shown = [s for s in steps if s % args.every == 0]
  if steps and steps[-1] not in shown:
    shown.append(steps[-1])
  for s in shown:
    loss, acc, sps = train[s]
    print(f'| {s} | {loss:.4f} | {acc:.3f} | {sps:.2f} |')

  if evals:
    print('\n### Held-out eval (24 validation clips, full metric family)\n')
    print('| step | onset F1 | onset+offset F1 | frame F1 | '
          'onset+vel F1 | invalid events |')
    print('|---|---|---|---|---|---|')
    for s in sorted(evals):
      d = evals[s]
      print(f"| {s} | {d['Onset F1']:.3f} | {d['Onset + offset F1']:.3f}"
            f" | {d['Frame F1']:.3f} | {d['Onset + velocity F1']:.3f}"
            f" | {d['Invalid events']:.1f} |")


if __name__ == '__main__':
  main()
