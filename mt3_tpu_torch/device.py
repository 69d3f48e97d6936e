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
