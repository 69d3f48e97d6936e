"""mt3_tpu_torch/tools/run_flagship.sh end to end on the CPU, at a small
width: the recipe's relaunch loop takes the train CLI's exit code 75 (here
forced at the first step by --exit_rss_gb) and resumes from the checkpoint
it wrote, then runs to the end with one evaluation pass on a corpus built
by mt3_tpu_torch.tools.make_corpus.

The recipe runs the interpreter that PYTHON names; here that is a shim,
written by the test, which runs the port's train CLI with mt3 cut to one
layer of 2 x 64 heads, batch 2, on the CPU, and which lowers
--exit_rss_gb on its first launch only.  Everything else is the recipe's
own: flags, paths, loop and logs.
"""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SHIM = '''
import dataclasses, os, sys
sys.path.insert(0, os.getcwd())
from mt3_tpu_torch.core import config as c
base = c.CONFIG_FACTORIES['mt3']
c.CONFIG_FACTORIES['mt3'] = lambda: dataclasses.replace(
    base(), model=dataclasses.replace(
        base().model, emb_dim=128, num_heads=2, head_dim=64, mlp_dim=128,
        num_encoder_layers=1, num_decoder_layers=1))
argv = sys.argv[3:]
assert sys.argv[1:3] == ['-m', 'mt3_tpu_torch.cli.train'], sys.argv
argv = ['2' if i and argv[i - 1] == '--batch_size' else a
        for i, a in enumerate(argv)]
marker = os.environ['FIRST_LAUNCH']
if not os.path.exists(marker):
  open(marker, 'w').close()
  argv = ['1e-6' if i and argv[i - 1] == '--exit_rss_gb' else a
          for i, a in enumerate(argv)]
from mt3_tpu_torch.cli import train
train.main(argv + ['--device', 'cpu'])
'''


def test_flagship_recipe_relaunches_on_exit_75(tmp_path):
  from mt3_tpu_torch.tools import make_corpus
  make_corpus.main(['--out', str(tmp_path / 'corpus'), '--num', '2',
                    '--num_validation', '1', '--num_test', '1',
                    '--duration', '2.048'])
  (tmp_path / 'shim.py').write_text(SHIM)
  python = tmp_path / 'python'
  python.write_text(f'#!/bin/bash\nexec {sys.executable} '
                    f'{tmp_path / "shim.py"} "$@"\n')
  python.chmod(0o755)
  run = tmp_path / 'run'
  proc = subprocess.run(
      ['bash', str(ROOT / 'mt3_tpu_torch' / 'tools' / 'run_flagship.sh')],
      capture_output=True, text=True, timeout=240,
      env={**{k: os.environ[k] for k in ('HOME', 'TMPDIR')
              if k in os.environ},
           'PATH': '/usr/bin:/bin', 'PYTHON': str(python), 'RUN': str(run),
           'CORPUS': str(tmp_path / 'corpus'), 'STEPS': '2',
           'EVAL_PERIOD': '2', 'FIRST_LAUNCH': str(tmp_path / 'launched'),
           'OMP_NUM_THREADS': '2'})
  log = (run / 'train.log').read_text()
  assert proc.returncode == 0, proc.stdout + proc.stderr + log
  assert re.search(r'trainer exited code 75\n.*launched trainer pid \d+ '
                   r'\(restart 1\)\n.*trainer exited code 0\n.*training '
                   r'complete', proc.stdout), proc.stdout
  assert 'saved restart checkpoint:' in log and 'resumed from step 1' in log
  assert 'step 0: loss=' in log and 'step 1: loss=' in log
  assert 'eval@2: onset F1 = ' in log
  assert sorted(p.name for p in (run / 'ckpt').iterdir()) == [
      'checkpoint_1.pt', 'checkpoint_2.pt']
  assert (run / 'logs' / 'metrics.jsonl').exists()
  assert (run / 'train.pid').read_text().strip().isdigit()
