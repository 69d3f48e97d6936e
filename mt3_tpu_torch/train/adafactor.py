"""Adafactor as a torch.optim.Optimizer (port of mt3_tpu/train/adafactor.py).

The optimizer the reference binds via gin (t5x Adafactor, decay_rate=0.8,
step_offset=0):

  * Factored second moments for a leaf whose two trailing dims are both
    >= 128: row/col exponential averages of squared gradients with decay
    1 - step^-decay_rate.  A stacked [layers, in, out] leaf is factored per
    layer (the statistics keep the leading axis).
  * Update clipping by the RMS of each leaf's whole update (threshold 1).
  * The step scaled by max(rms(param), 1e-3) (multiply_by_parameter_scale).
  * No first moment.  eps = 1e-30.

State per leaf, float32: 'v_row', 'v_col', 'v_full' with the JAX package's
shapes ((1,) placeholders where unused), and 'step', the same for all
leaves.  The parameters are updated in place.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

# Minimum size of both trailing dims for factoring; norm-scale stacks like
# [layers, emb] stay unfactored.
MIN_DIM_SIZE_TO_FACTOR = 128
# The reference's settings (gin/model.gin:28-33 and the t5x defaults), the
# only ones the JAX package passes to apply_updates.
DECAY_RATE = 0.8
CLIPPING_THRESHOLD = 1.0
EPS = 1e-30
EPS_SCALE = 1e-3


def factored(shape) -> bool:
  return (len(shape) >= 2
          and shape[-1] >= MIN_DIM_SIZE_TO_FACTOR
          and shape[-2] >= MIN_DIM_SIZE_TO_FACTOR)


def _rms(x: torch.Tensor) -> torch.Tensor:
  return torch.sqrt(torch.mean(torch.square(x)))


class Adafactor(torch.optim.Optimizer):
  """Adafactor over a list of float32 leaf tensors.

  The learning rate is set per step by the caller (param_groups' 'lr'),
  as the train step computes it from the schedule.
  """

  def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3):
    super().__init__(params, dict(lr=lr))
    for group in self.param_groups:
      for p in group['params']:
        self.state[p].update(_init_state(p))

  @torch.no_grad()
  def step(self, closure=None):
    """One update of every leaf; a leaf without a gradient gets zeros."""
    loss = None
    if closure is not None:
      with torch.enable_grad():
        loss = closure()
    for group in self.param_groups:
      for p in group['params']:
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        p.copy_(_update_leaf(p, grad, self.state[p], group['lr']))
    return loss


def _init_state(p: torch.Tensor) -> dict:
  """Zero statistics for one leaf, in the JAX package's shapes."""
  kw = dict(dtype=torch.float32, device=p.device)
  if factored(p.shape):
    return {'step': 0,
            'v_row': torch.zeros(p.shape[:-1], **kw),
            'v_col': torch.zeros(p.shape[:-2] + p.shape[-1:], **kw),
            'v_full': torch.zeros((1,), **kw)}
  return {'step': 0,
          'v_row': torch.zeros((1,), **kw),
          'v_col': torch.zeros((1,), **kw),
          'v_full': torch.zeros(p.shape, **kw)}


def _update_leaf(p, grad, state, lr) -> torch.Tensor:
  """apply_updates' update_leaf; updates `state` in place, returns new p."""
  state['step'] += 1
  # Scalars in float32 on the host, as the JAX package computes them; a
  # Python float multiplies a float32 tensor in float32.
  beta2 = float(np.float32(1.0) - np.power(np.float32(state['step']),
                                           np.float32(-DECAY_RATE)))
  g = grad.to(torch.float32)
  g2 = torch.square(g) + EPS
  if factored(p.shape):
    v_row = beta2 * state['v_row'] + (1.0 - beta2) * torch.mean(g2, dim=-1)
    v_col = beta2 * state['v_col'] + (1.0 - beta2) * torch.mean(g2, dim=-2)
    state['v_row'].copy_(v_row)
    state['v_col'].copy_(v_col)
    # V ~ (row x col) / mean(row), per layer of a stacked leaf.
    row_mean = torch.mean(v_row, dim=-1, keepdim=True)
    row_factor = torch.rsqrt(v_row / row_mean)
    col_factor = torch.rsqrt(v_col)
    update = g * row_factor[..., None] * col_factor[..., None, :]
  else:
    v_full = beta2 * state['v_full'] + (1.0 - beta2) * g2
    state['v_full'].copy_(v_full)
    update = g * torch.rsqrt(v_full)

  update = update / torch.clamp(_rms(update) / CLIPPING_THRESHOLD, min=1.0)
  p32 = p.to(torch.float32)
  # multiply_by_parameter_scale: the step scaled by max(rms(p), 1e-3).
  scale = float(np.float32(lr)) * torch.clamp(_rms(p32), min=EPS_SCALE)
  return p32 - scale * update
