"""Adafactor as MT3 trains with it, and its learning rate, in plain PyTorch.

t5x's Adafactor with MT3's settings (decay rate 0.8, step offset 0, no
first moment, update clipping at RMS 1, steps scaled by max(rms(param),
1e-3), eps 1e-30): factored second moments for a leaf whose two trailing
dimensions are both at least 128, one factor pair per slice of the
leading axes.  The learning rate is constant after a linear warm-up.
"""

from __future__ import annotations

import torch

DECAY_RATE = 0.8
EPS = 1e-30
EPS_SCALE = 1e-3
MIN_DIM_TO_FACTOR = 128


def learning_rate(run, step):
  warmup = min(1.0, step / max(1.0, run['warmup_steps']))
  return run['learning_rate'] * warmup


def factored(shape):
  return (len(shape) >= 2 and shape[-1] >= MIN_DIM_TO_FACTOR
          and shape[-2] >= MIN_DIM_TO_FACTOR)


def init(p):
  if factored(p.shape):
    return {'row': torch.zeros(p.shape[:-1], device=p.device),
            'col': torch.zeros(p.shape[:-2] + p.shape[-1:], device=p.device)}
  return {'full': torch.zeros(p.shape, device=p.device)}


def update(p, g, state, step, lr):
  """The parameter after one step (step counts from 1); `state` in place."""
  beta2 = 1.0 - step ** -DECAY_RATE
  g2 = g * g + EPS
  if 'row' in state:
    state['row'] = beta2 * state['row'] + (1 - beta2) * g2.mean(-1)
    state['col'] = beta2 * state['col'] + (1 - beta2) * g2.mean(-2)
    row = state['row'] / state['row'].mean(-1, keepdim=True)
    u = g * torch.rsqrt(row)[..., None] * torch.rsqrt(state['col'])[..., None, :]
  else:
    state['full'] = beta2 * state['full'] + (1 - beta2) * g2
    u = g * torch.rsqrt(state['full'])
  u = u / torch.clamp(torch.sqrt(torch.mean(u * u)), min=1.0)
  scale = lr * torch.clamp(torch.sqrt(torch.mean(p * p)), min=EPS_SCALE)
  return p - scale * u
