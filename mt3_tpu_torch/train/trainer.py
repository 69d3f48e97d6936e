"""The train step and its state: LR schedule, train state, Trainer.

PyTorch port of mt3_tpu/train/trainer.py, the slice of the t5x Trainer
MT3 uses (constant LR 1e-3 with linear warmup, Adafactor, the loss of
losses.py).  Where the JAX package jits one sharded step, the port runs
eagerly on one device: forward, backward of the summed loss, Adafactor in
place.  Dropout masks come from a host generator seeded from
(seed, step), the role of jax.random.fold_in(rng, step).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core.config import ModelConfig, RunConfig, SpectrogramConfig
from mt3_tpu_torch.device import resolve_device
from mt3_tpu_torch.models import t5
from mt3_tpu_torch.ops import spectrogram
from mt3_tpu_torch.train import adafactor, losses

MULTI_DEVICE_NOT_PORTED = (
    'training over a device mesh is not ported yet (ROADMAP.md, modules to '
    'port: multi-device); pass mesh=None')


@dataclasses.dataclass
class TrainState:
  """Step count, parameter tree (float32 leaves) and optimizer."""
  step: int
  params: params_lib.Tree
  optimizer: adafactor.Adafactor


def create_learning_rate_fn(run: RunConfig):
  """Constant LR with linear warmup (train.gin:153-159), in float32."""
  def lr(step) -> float:
    warmup = np.minimum(np.float32(1.0), np.float32(step) / np.maximum(
        np.float32(1.0), np.float32(run.warmup_steps)))
    return float(np.float32(run.learning_rate) * warmup)
  return lr


def init_train_state(model_config: ModelConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None, params=None) -> TrainState:
  """Parameters (drawn from `generator`, or a copy of `params`) + fresh
  Adafactor, on `device` (CUDA unless 'cpu' is asked for).  The step
  updates the parameters in place, so a given tree is copied, never
  aliased."""
  device = resolve_device(device)
  if params is None:
    params = params_lib.init_params(model_config, generator, device)
  params = params_lib.tree_map(
      lambda t: t.detach().to(device=device, dtype=torch.float32,
                              copy=True).requires_grad_(), params)
  optimizer = adafactor.Adafactor(params_lib.tree_leaves(params))
  return TrainState(step=0, params=params, optimizer=optimizer)


def dropout_generator(seed: int, step: int) -> torch.Generator:
  """The host generator of one step's dropout draws, from (seed, step)."""
  words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
  return torch.Generator().manual_seed(
      (int(words[0]) << 32 | int(words[1])) & (2**63 - 1))


def _loss_and_metrics(params, batch, model_config, run_config, generator):
  logits = t5.forward(params, model_config, batch['encoder_input_tokens'],
                      batch['decoder_input_tokens'],
                      batch['decoder_target_tokens'], generator=generator)
  weights = batch['decoder_loss_weights'].to(torch.float32)
  total, z_term, weight_sum = losses.cross_entropy_with_z_loss(
      logits, batch['decoder_target_tokens'], weights,
      label_smoothing=run_config.label_smoothing, z_loss=run_config.z_loss)
  with torch.no_grad():
    metrics = losses.compute_metrics(logits, batch['decoder_target_tokens'],
                                     weights)
    denominator = torch.clamp(weight_sum, min=1e-8)
    metrics.update(loss=total.detach() / denominator,
                   z_loss=z_term.detach() / denominator)
  return total, metrics


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
               seed: int, model_config: ModelConfig, run_config: RunConfig,
               num_microbatches: int = 0
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
  """One training step: forward, summed loss, grads, Adafactor update.

  `batch` holds model features on the parameters' device.  Updates
  `state` in place and returns it with 0-d tensor metrics.
  num_microbatches > 1 accumulates gradients over sequential slices of
  the batch (each slice draws the step's dropout masks, as in the JAX
  package); the metrics are the last slice's.
  """
  leaves = params_lib.tree_leaves(state.params)
  for p in leaves:
    p.grad = None

  def generator():
    return (dropout_generator(seed, state.step)
            if model_config.dropout_rate > 0 else None)

  if num_microbatches and num_microbatches > 1:
    batch_size = batch['decoder_target_tokens'].shape[0]
    if batch_size % num_microbatches:
      raise ValueError('batch size not divisible by num_microbatches')
    micro = batch_size // num_microbatches
    for i in range(num_microbatches):
      sliced = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
      total, metrics = _loss_and_metrics(state.params, sliced, model_config,
                                         run_config, generator())
      total.backward()
  else:
    total, metrics = _loss_and_metrics(state.params, batch, model_config,
                                       run_config, generator())
    total.backward()

  lr = create_learning_rate_fn(run_config)(state.step)
  with torch.no_grad():
    grad_norm = torch.sqrt(sum(torch.sum(torch.square(p.grad.float()))
                               for p in leaves))
  for group in state.optimizer.param_groups:
    group['lr'] = lr
  state.optimizer.step()
  with torch.no_grad():
    metrics['learning_rate'] = torch.tensor(lr, dtype=torch.float32)
    metrics['grad_norm'] = grad_norm
    metrics['param_norm'] = torch.sqrt(sum(torch.sum(torch.square(p))
                                           for p in leaves))
  for p in leaves:
    p.grad = None
  state.step += 1
  return state, metrics


def state_tree(state: TrainState) -> dict:
  """The train state as a tree shaped like the JAX package's TrainState:
  {'step', 'params', 'opt_state': {'v_row', 'v_col', 'v_full'}}, each
  optimizer statistic a tree shaped like the parameters."""
  opt = state.optimizer.state

  def stat(name):
    return params_lib.tree_map(lambda p: opt[p][name], state.params)
  return {'step': state.step,
          'params': params_lib.tree_map(lambda p: p.detach(), state.params),
          'opt_state': {name: stat(name)
                        for name in ('v_row', 'v_col', 'v_full')}}


def load_state_tree(state: TrainState, tree: Mapping[str, Any]) -> None:
  """Copy a state_tree (torch or numpy leaves, e.g. a JAX TrainState's
  np.asarray'd leaves) into `state` in place."""
  step = int(np.asarray(tree['step']))
  params_lib.check_structure(tree['params'], state.params, 'params')
  for name in ('v_row', 'v_col', 'v_full'):
    params_lib.check_structure(tree['opt_state'][name], state.params,
                               f'opt_state {name}')
  leaves = params_lib.tree_leaves(state.params)
  new_params = params_lib.tree_leaves(tree['params'])
  stats = {name: params_lib.tree_leaves(tree['opt_state'][name])
           for name in ('v_row', 'v_col', 'v_full')}
  with torch.no_grad():
    for i, p in enumerate(leaves):
      new = new_params[i]
      new = new if torch.is_tensor(new) else torch.from_numpy(np.array(new))
      _check_shape(new, p)
      p.copy_(new)
      slot = state.optimizer.state[p]
      slot['step'] = step
      for name, values in stats.items():
        value = values[i]
        value = (value if torch.is_tensor(value)
                 else torch.from_numpy(np.array(value)))
        if tuple(value.shape) != tuple(slot[name].shape):
          raise ValueError(f'{name} shape {tuple(value.shape)}, expected '
                           f'{tuple(slot[name].shape)}')
        slot[name] = value.to(device=p.device, dtype=torch.float32).clone()
  state.step = step


def model_batch(batch: Mapping[str, Any], spectrogram_config: SpectrogramConfig,
                device) -> Dict[str, torch.Tensor]:
  """A pipeline batch -> model features on `device`.

  Raw 'encoder_input_frames' [b, frames, hop] become log-mel
  'encoder_input_tokens' on the device (kernel A on a CUDA device), as the
  JAX train step computes the spectrogram inside the step.
  """
  def put(name, dtype):
    return torch.as_tensor(np.asarray(batch[name])).to(device, dtype)
  return {
      'encoder_input_tokens': spectrogram.frames_to_logmel(
          put('encoder_input_frames', torch.float32), spectrogram_config),
      'decoder_target_tokens': put('decoder_target_tokens', torch.int32),
      'decoder_input_tokens': put('decoder_input_tokens', torch.int32),
      'decoder_loss_weights': put('decoder_loss_weights', torch.float32),
  }


class StagedBatches:
  """Pipeline batches staged on `device` by a prefetch thread.

  Each batch goes through model_batch on pipeline.prefetch's producer
  thread, so its transfer and log-mel overlap the previous step.  close()
  stops the producer before it draws another batch and drains the queue,
  so the thread exits; `staged` counts the batches made until then.
  """

  def __init__(self, batches: Iterator, spectrogram_config: SpectrogramConfig,
               device):
    from mt3_tpu_torch.data import pipeline
    self.staged = 0
    self._stop = threading.Event()

    def until_stopped():
      while not self._stop.is_set():
        yield next(batches)

    def stage(batch):
      self.staged += 1
      return model_batch(batch, spectrogram_config, device)

    self._queue = pipeline.prefetch(until_stopped(), transform=stage)

  def __iter__(self):
    return self

  def __next__(self):
    return next(self._queue)

  def close(self):
    self._stop.set()
    for _ in self._queue:
      pass


@dataclasses.dataclass
class Trainer:
  """Holds the train state on one device and steps it."""
  model_config: ModelConfig
  run_config: RunConfig
  mesh: Optional[Any] = None
  seed: int = 0
  num_microbatches: int = 0
  device: Any = None

  def __post_init__(self):
    if self.mesh is not None:
      raise NotImplementedError(MULTI_DEVICE_NOT_PORTED)
    self.device = resolve_device(self.device)
    self._async_saver = None
    generator = torch.Generator().manual_seed(self.seed)
    self.state = init_train_state(self.model_config, generator, self.device)

  def step(self, batch) -> Dict[str, torch.Tensor]:
    """One step on a batch of model features (numpy arrays or tensors)."""
    batch = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v).to(self.device)
             for k, v in batch.items()}
    self.state, metrics = train_step(
        self.state, batch, self.seed, self.model_config, self.run_config,
        self.num_microbatches)
    return metrics

  def save(self, directory: str, asynchronous: bool = False) -> str:
    """Checkpoint the full train state (params + optimizer + step).

    asynchronous=True copies the state to host memory before it returns
    and overlaps the file write with the following steps (call
    finalize_saves() before exiting).
    """
    from mt3_tpu_torch.train import checkpoint as ckpt_lib
    if asynchronous:
      if self._async_saver is None:
        self._async_saver = ckpt_lib.AsyncCheckpointSaver()
      return self._async_saver.save(directory, self.state)
    return ckpt_lib.save_checkpoint(directory, self.state)

  def finalize_saves(self) -> None:
    """Block until any pending asynchronous checkpoint completes."""
    if self._async_saver is not None:
      self._async_saver.wait()

  def load_params(self, params) -> None:
    """Warm-start from a parameter tree: fresh optimizer, step kept.
    Raises ValueError, before anything changes, on a tree whose key paths
    or shapes differ from the model's."""
    params_lib.check_structure(params, self.state.params, 'params')
    for new, old in zip(params_lib.tree_leaves(params),
                        params_lib.tree_leaves(self.state.params)):
      _check_shape(new, old)
    step = self.state.step
    self.state = init_train_state(
        self.model_config, device=self.device,
        params=params_lib.tree_map(torch.as_tensor, params))
    self.state.step = step

  def restore(self, directory_or_path: str) -> int:
    """Restore the full train state; returns the restored step.

    Dataset state is not checkpointed: training resumes from the saved
    step with a fresh data pipeline, as in the reference.
    """
    from mt3_tpu_torch.train import checkpoint as ckpt_lib
    path = (ckpt_lib.latest_checkpoint(directory_or_path)
            or directory_or_path)
    ckpt_lib.restore_checkpoint(path, self.state)
    return self.state.step


def _check_shape(new, old):
  if tuple(np.shape(new)) != tuple(old.shape):
    raise ValueError(f'shape mismatch {np.shape(new)} vs {tuple(old.shape)}')


def make_train_batch(rng: np.random.RandomState, batch_size: int,
                     inputs_length: int, targets_length: int,
                     input_depth: int, vocab_size: int) -> dict:
  """Random batch with the training feature layout, for tests/benchmarks."""
  targets = rng.randint(3, vocab_size,
                        size=(batch_size, targets_length)).astype(np.int32)
  # Autoregressive shift: input i attends target i-1; BOS = 0.
  dec_inputs = np.concatenate(
      [np.zeros((batch_size, 1), np.int32), targets[:, :-1]], axis=1)
  return {
      'encoder_input_tokens': rng.randn(
          batch_size, inputs_length, input_depth).astype(np.float32),
      'decoder_target_tokens': targets,
      'decoder_input_tokens': dec_inputs,
      'decoder_loss_weights': (targets > 0).astype(np.int32),
  }
