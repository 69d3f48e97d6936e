"""Checkpoints of the whole train state in the port's own torch format.

Each checkpoint is one file, <directory>/checkpoint_<step>.pt, written with
torch.save: trainer.state_tree (step, parameters, Adafactor statistics).
Restart semantics follow the reference: dataset state is not saved, and
training resumes from the latest step with a fresh data pipeline.

Reading the JAX package's orbax checkpoints or published T5X checkpoints
is not ported yet (ROADMAP.md, modules to port: checkpoint import).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from mt3_tpu_torch.train import trainer as trainer_lib

_NAME = re.compile(r'^checkpoint_(\d+)\.pt$')


def save_checkpoint(directory: str, state: 'trainer_lib.TrainState') -> str:
  """Write the train state; returns the checkpoint's path."""
  directory = os.path.abspath(directory)
  os.makedirs(directory, exist_ok=True)
  path = os.path.join(directory, f'checkpoint_{state.step}.pt')
  tmp = path + '.tmp'
  torch.save(trainer_lib.state_tree(state), tmp)
  os.replace(tmp, path)
  return path


def latest_checkpoint(directory: str) -> Optional[str]:
  """The checkpoint of the highest step in `directory`, or None."""
  if not os.path.isdir(directory):
    return None
  steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(directory))
           if m]
  if not steps:
    return None
  return os.path.join(directory, f'checkpoint_{max(steps)}.pt')


def restore_checkpoint(path: str, state: 'trainer_lib.TrainState') -> None:
  """Load a checkpoint written by save_checkpoint into `state` in place."""
  if not os.path.isfile(path):
    raise FileNotFoundError(f'no checkpoint at {path}')
  tree = torch.load(path, map_location='cpu', weights_only=True)
  trainer_lib.load_state_tree(state, tree)
