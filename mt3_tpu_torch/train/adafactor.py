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

On a mesh (parallel/partitioning.Mesh) a leaf may be this rank's block of
one of its two trailing dimensions (`dims`, partitioning.model_dims).  The
update is the whole leaf's: factoring is decided on the global shape; a
mean over the split dimension (v_row of a column block, v_col and the
row mean of a row block) is a sum all-reduced over 'model'; the RMS of
the update (for the clip) and of the parameter are over the whole leaf.
The statistics follow the leaf: v_full and the factor along the split
dimension are blocks, the other factor is whole on every rank.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from mt3_tpu_torch.parallel import partitioning

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


class _Split:
  """A leaf split over 'model' along `dim` (-1 or -2) of `mesh`."""

  def __init__(self, dim: int, mesh):
    self.dim, self.mesh = dim, mesh

  def mean(self, x: torch.Tensor, dim: int, keepdim: bool = False):
    """The mean along `dim` of x, whose `dim` is split over 'model'."""
    total = partitioning.all_reduce(torch.sum(x, dim=dim, keepdim=keepdim),
                                    self.mesh, partitioning.MODEL_AXIS)
    return total / (x.shape[dim] * self.mesh.model)

  def rms(self, x: torch.Tensor) -> torch.Tensor:
    total = partitioning.all_reduce(torch.sum(torch.square(x)), self.mesh,
                                    partitioning.MODEL_AXIS)
    return torch.sqrt(total / (x.numel() * self.mesh.model))


class Adafactor(torch.optim.Optimizer):
  """Adafactor over a list of float32 leaf tensors.

  The learning rate is set per step by the caller (param_groups' 'lr'),
  as the train step computes it from the schedule.  On a mesh, dims[i]
  is the dimension of leaf i split over 'model' (None: whole).
  """

  def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
               dims: Optional[Sequence[Optional[int]]] = None, mesh=None):
    super().__init__(params, dict(lr=lr))
    leaves = [p for group in self.param_groups for p in group['params']]
    dims = dims if dims is not None else [None] * len(leaves)
    self.splits = {p: (None if dim is None or mesh is None
                       else _Split(dim, mesh))
                   for p, dim in zip(leaves, dims)}
    for p in leaves:
      self.state[p].update(_init_state(p, self.splits[p]))

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
        p.copy_(_update_leaf(p, grad, self.state[p], group['lr'],
                             self.splits[p]))
    return loss


def _global_shape(p: torch.Tensor, split: Optional[_Split]):
  shape = list(p.shape)
  if split is not None:
    shape[split.dim] *= split.mesh.model
  return shape


def _init_state(p: torch.Tensor, split: Optional[_Split] = None) -> dict:
  """Zero statistics for one leaf, in the JAX package's shapes (a split
  leaf's: blocks along the split dimension)."""
  kw = dict(dtype=torch.float32, device=p.device)
  if factored(_global_shape(p, split)):
    return {'step': 0,
            'v_row': torch.zeros(p.shape[:-1], **kw),
            'v_col': torch.zeros(p.shape[:-2] + p.shape[-1:], **kw),
            'v_full': torch.zeros((1,), **kw)}
  return {'step': 0,
          'v_row': torch.zeros((1,), **kw),
          'v_col': torch.zeros((1,), **kw),
          'v_full': torch.zeros(p.shape, **kw)}


def _update_leaf(p, grad, state, lr,
                 split: Optional[_Split] = None) -> torch.Tensor:
  """apply_updates' update_leaf; updates `state` in place, returns new p."""
  state['step'] += 1
  # Scalars in float32 on the host, as the JAX package computes them; a
  # Python float multiplies a float32 tensor in float32.
  beta2 = float(np.float32(1.0) - np.power(np.float32(state['step']),
                                           np.float32(-DECAY_RATE)))
  g = grad.to(torch.float32)
  g2 = torch.square(g) + EPS
  split_dim = split.dim if split is not None else None

  def mean(x, dim, split_here, keepdim=False):
    return (split.mean(x, dim, keepdim) if split_here
            else torch.mean(x, dim=dim, keepdim=keepdim))

  def rms(x):
    return _rms(x) if split is None else split.rms(x)

  if factored(_global_shape(p, split)):
    v_row = beta2 * state['v_row'] + (1.0 - beta2) * mean(
        g2, -1, split_dim == -1)
    v_col = beta2 * state['v_col'] + (1.0 - beta2) * mean(
        g2, -2, split_dim == -2)
    state['v_row'].copy_(v_row)
    state['v_col'].copy_(v_col)
    # V ~ (row x col) / mean(row), per layer of a stacked leaf.
    row_mean = mean(v_row, -1, split_dim == -2, keepdim=True)
    row_factor = torch.rsqrt(v_row / row_mean)
    col_factor = torch.rsqrt(v_col)
    update = g * row_factor[..., None] * col_factor[..., None, :]
  else:
    v_full = beta2 * state['v_full'] + (1.0 - beta2) * g2
    state['v_full'].copy_(v_full)
    update = g * torch.rsqrt(v_full)

  update = update / torch.clamp(rms(update) / CLIPPING_THRESHOLD, min=1.0)
  p32 = p.to(torch.float32)
  # multiply_by_parameter_scale: the step scaled by max(rms(p), 1e-3).
  scale = float(np.float32(lr)) * torch.clamp(rms(p32), min=EPS_SCALE)
  return p32 - scale * update
