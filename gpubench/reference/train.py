"""The first training steps of MT3, in plain PyTorch.

From the benchmark's parameters and batches (raw audio frames and target
tokens), each step computes log-mel features, the teacher-forced forward
pass with the step's dropout masks (reference/masks.py), the summed
cross entropy with z-loss, its gradients and the Adafactor update, in
blocks of rows whose gradients add up to the batch's.
"""

from __future__ import annotations

import torch

from gpubench.reference import adafactor, logmel, masks, model


def _tree(flat):
  tree = {}
  for path, leaf in flat.items():
    *parents, name = path.split('.')
    node = tree
    for key in parents:
      node = node.setdefault(key, {})
    node[name] = leaf
  return tree


class Steps:
  """The reference's training, one step at a time.  params: {path:
  float32 tensor}, copied; a batch is a dict with 'encoder_input_frames'
  [b, frames, hop] and 'decoder_target_tokens' [b, T] (numpy)."""

  def __init__(self, params, cfg, seed, device, prec='float32', block=16):
    self.params = {k: v.detach().clone() for k, v in params.items()}
    self.opt = {k: adafactor.init(v) for k, v in self.params.items()}
    self.cfg, self.seed, self.device = cfg, seed, device
    self.prec, self.block = prec, block
    self.count = 0
    self.grad_norms = None   # {path: norm of the last step's gradient}

  def step(self, batch) -> float:
    """One step; returns its per-token loss."""
    mcfg, run, block = self.cfg['model'], self.cfg['run'], self.block
    device, prec, flat = self.device, self.prec, self.params
    frames = torch.as_tensor(batch['encoder_input_frames'])
    targets = torch.as_tensor(batch['decoder_target_tokens']).to(
        device, torch.long)
    b, n_frames = frames.shape[0], frames.shape[1]
    drop = (masks.draw(mcfg, self.seed, self.count, b, n_frames,
                       targets.shape[1], device)
            if mcfg['dropout_rate'] > 0 else None)
    for leaf in flat.values():
      leaf.requires_grad_(True)
      leaf.grad = None
    tree = _tree(flat)
    total = weight = 0.0
    for s in range(0, b, block):
      rows = slice(s, min(s + block, b))
      mel = logmel.logmel(frames[rows].reshape(-1, frames[rows].shape[1]
                                               * frames.shape[2]).to(device),
                          self.cfg['spectrogram'])
      sub = None if drop is None else masks.rows(drop, rows.start, rows.stop)
      enc = model.encode(tree, mcfg, mel, prec, sub)
      logits = model.decode(tree, mcfg, enc, model.shift_right(targets[rows]),
                            prec, sub)
      weights = (targets[rows] > 0).to(torch.float32)
      loss, w = model.loss(logits, targets[rows], weights, run['z_loss'],
                           run['label_smoothing'])
      loss.backward()
      total += float(loss.detach())
      weight += float(w)
    self.grad_norms = {k: float(v.grad.norm()) for k, v in flat.items()}
    lr = adafactor.learning_rate(run, self.count)
    self.count += 1
    with torch.no_grad():
      self.params = {k: adafactor.update(v.detach(), v.grad, self.opt[k],
                                         self.count, lr)
                     for k, v in flat.items()}
    return total / weight


def steps(params, cfg, batches, seed, device, prec='float32', block=16):
  """Returns (per-token loss of each step, {path: norm of the first
  step's gradient}, {path: parameter after the steps})."""
  run = Steps(params, cfg, seed, device, prec, block)
  losses, first_grads = [], None
  for batch in batches:
    losses.append(run.step(batch))
    if first_grads is None:
      first_grads = run.grad_norms
  return losses, first_grads, run.params
