"""Device selection for the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
  """`device`, or CUDA when None.  Never falls back to the CPU by itself."""
  device = torch.device('cuda' if device is None else device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'mt3_tpu_torch runs on a CUDA device by default and none is '
        "available; pass device='cpu' to run on the CPU")
  return device


def describe(device) -> str:
  """The line a measuring tool prints before its results: the card's name
  and power limit as `nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader` gives them (a card may be set below its maximum
  and then runs slower), or, on the CPU, a label that says the times are
  the host's."""
  import subprocess
  device = torch.device(device)
  if device.type != 'cuda':
    return 'device: cpu (times below are the host CPU\'s, not a GPU\'s)'
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout
  except (OSError, subprocess.SubprocessError):
    return f'{torch.cuda.get_device_name(device)}, power limit: not read'
  lines = out.strip().splitlines()
  index = device.index or 0
  return lines[index] if index < len(lines) else lines[0]


def synchronize(device) -> None:
  """Wait for the device's queued work (nothing to wait for on the CPU)."""
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize(device)
