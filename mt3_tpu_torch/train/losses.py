"""Loss functions: cross entropy with z-loss and label smoothing.

PyTorch port of mt3_tpu/train/losses.py: the t5x loss the reference binds
via gin (z_loss=1e-4, label_smoothing=0, loss_normalizing_factor=None;
pretrain uses label_smoothing=0.1).

The loss is a sum over tokens.  On a mesh each data rank sums its own
rows; summing those sums over the data group (partitioning.data_sum, as
compute_metrics does for its counts) gives the global batch's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mt3_tpu_torch.parallel import partitioning
from mt3_tpu_torch.parallel.partitioning import Mesh


def _log32(x: float) -> torch.Tensor:
  return torch.log(torch.tensor(x, dtype=torch.float32))


def cross_entropy_with_z_loss(
    logits: torch.Tensor,     # [b, len, vocab] float32
    targets: torch.Tensor,    # [b, len] integer ids
    weights: torch.Tensor,    # [b, len] loss weights (non-padding = 1)
    label_smoothing: float = 0.0,
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Returns (total_loss, z_loss_term, weight_sum).

  total_loss is summed over tokens (t5x convention with
  loss_normalizing_factor=None); callers divide by weight_sum for
  per-token metrics.
  """
  vocab_size = logits.shape[-1]
  confidence = 1.0 - label_smoothing
  low_confidence = label_smoothing / (vocab_size - 1)
  # In float32, as the JAX package computes it.
  normalizing_constant = -(
      confidence * _log32(confidence + 1e-20)
      + (vocab_size - 1) * low_confidence * _log32(low_confidence + 1e-20)
  ).to(logits.device)

  one_hot = F.one_hot(targets.to(torch.long), vocab_size).to(torch.float32)
  soft_targets = one_hot * confidence + (1.0 - one_hot) * low_confidence

  log_z = torch.logsumexp(logits, dim=-1)
  log_softmax = logits - log_z[..., None]
  ce = -torch.sum(soft_targets * log_softmax, dim=-1) - normalizing_constant

  z_term = z_loss * torch.square(log_z)
  per_token = (ce + z_term) * weights

  total = torch.sum(per_token)
  total_z = torch.sum(z_term * weights)
  weight_sum = torch.sum(weights)
  return total, total_z, weight_sum


def compute_metrics(logits: torch.Tensor, targets: torch.Tensor,
                    weights: torch.Tensor,
                    mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
  """Token-level accuracy and the weight sum, for logging; on a mesh, of
  the global batch (both counts summed over the data group)."""
  predictions = torch.argmax(logits, dim=-1)
  correct = (predictions == targets.to(torch.long)).to(torch.float32) * weights
  correct, total_weight = partitioning.data_sum(mesh, torch.sum(correct),
                                                torch.sum(weights))
  weight_sum = torch.clamp(total_weight, min=1e-8)
  return {
      'accuracy': correct / weight_sum,
      'weight_sum': total_weight,
  }
