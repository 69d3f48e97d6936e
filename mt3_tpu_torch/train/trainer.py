"""The train step and its state: LR schedule, train state, Trainer.

PyTorch port of mt3_tpu/train/trainer.py, the slice of the t5x Trainer
MT3 uses (constant LR 1e-3 with linear warmup, Adafactor, the loss of
losses.py).  Where the JAX package jits one sharded step, the port runs
eagerly: forward, backward of the summed loss, Adafactor in place.
Dropout masks come from a host generator seeded from (seed, step), the
role of jax.random.fold_in(rng, step).

On a mesh (parallel/partitioning.Mesh, one process per device) every rank
builds the full state from the seed and keeps its shards
(partitioning.model_dims over params.param_axes), and steps on its own
rows of the global batch.  The loss is a sum over tokens, so after the
backward pass the gradients are summed (not averaged) over the data
group; the metrics are the global batch's, and grad_norm / param_norm
count each whole leaf once.  state_tree gathers the shards into the full
tree, which a checkpoint holds, and load_state_tree / load_params take a
full tree and keep the rank's shards.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core.config import ModelConfig, RunConfig, SpectrogramConfig
from mt3_tpu_torch.device import resolve_device
from mt3_tpu_torch.models import t5
from mt3_tpu_torch.ops import spectrogram
from mt3_tpu_torch.parallel import partitioning
from mt3_tpu_torch.parallel.partitioning import Mesh
from mt3_tpu_torch.train import adafactor, losses
from mt3_tpu_torch.utils import profiling


@dataclasses.dataclass
class TrainState:
  """Step count, parameter tree (float32 leaves) and optimizer; on a mesh,
  the mesh and the tree of each leaf's dimension split over 'model'."""
  step: int
  params: params_lib.Tree
  optimizer: adafactor.Adafactor
  mesh: Optional[Mesh] = None
  dims: Optional[params_lib.Tree] = None


def create_learning_rate_fn(run: RunConfig):
  """Constant LR with linear warmup (train.gin:153-159), in float32."""
  def lr(step) -> float:
    warmup = np.minimum(np.float32(1.0), np.float32(step) / np.maximum(
        np.float32(1.0), np.float32(run.warmup_steps)))
    return float(np.float32(run.learning_rate) * warmup)
  return lr


def init_train_state(model_config: ModelConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None, params=None,
                     mesh: Optional[Mesh] = None) -> TrainState:
  """Parameters (drawn from `generator`, or a copy of `params`) + fresh
  Adafactor, on `device` (CUDA unless 'cpu' is asked for; the mesh's
  device on a mesh).  The step updates the parameters in place, so a given
  tree is copied, never aliased.  On a mesh the full tree is drawn (or
  given) on every rank and the rank keeps its shards."""
  dims = None
  if mesh is not None:
    device = mesh.device
    if params is None:
      params = params_lib.init_params(model_config, generator)
    dims = partitioning.model_dims(params_lib.param_axes(model_config), mesh,
                                   model_config)
    params = params_lib.shard_tree(params, dims, mesh)
  device = resolve_device(device)
  if params is None:
    params = params_lib.init_params(model_config, generator, device)
  params = params_lib.tree_map(
      lambda t: t.detach().to(device=device, dtype=torch.float32,
                              copy=True).requires_grad_(), params)
  optimizer = adafactor.Adafactor(
      params_lib.tree_leaves(params),
      dims=None if dims is None else params_lib.tree_leaves(dims), mesh=mesh)
  return TrainState(step=0, params=params, optimizer=optimizer, mesh=mesh,
                    dims=dims)


def dropout_generator(seed: int, step: int) -> torch.Generator:
  """The host generator of one step's dropout draws, from (seed, step)."""
  words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
  return torch.Generator().manual_seed(
      (int(words[0]) << 32 | int(words[1])) & (2**63 - 1))


def _loss_and_metrics(params, batch, model_config, run_config, generator,
                      mesh=None):
  logits = t5.forward(params, model_config, batch['encoder_input_tokens'],
                      batch['decoder_input_tokens'],
                      batch['decoder_target_tokens'], generator=generator,
                      mesh=mesh)
  weights = batch['decoder_loss_weights'].to(torch.float32)
  total, z_term, weight_sum = losses.cross_entropy_with_z_loss(
      logits, batch['decoder_target_tokens'], weights,
      label_smoothing=run_config.label_smoothing, z_loss=run_config.z_loss)
  with torch.no_grad():
    metrics = losses.compute_metrics(logits, batch['decoder_target_tokens'],
                                     weights, mesh)
    loss_sum, z_sum, weight_sum = partitioning.data_sum(
        mesh, total.detach(), z_term.detach(), weight_sum)
    denominator = torch.clamp(weight_sum, min=1e-8)
    metrics.update(loss=loss_sum / denominator, z_loss=z_sum / denominator)
  return total, metrics


def _sum_grads_over_data(leaves, mesh: Mesh) -> None:
  """Sum every gradient over the data group (one all-reduce of all of
  them): each data rank's loss is the sum over its own rows."""
  grads = [p.grad if p.grad is not None else torch.zeros_like(p)
           for p in leaves]
  flat = partitioning.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                                 mesh, partitioning.DATA_AXIS)
  for p, g in zip(leaves, flat.split([g.numel() for g in grads])):
    p.grad = g.view_as(p)


def _norm(values, state: TrainState) -> torch.Tensor:
  """sqrt of the sum of per-leaf sums of squares over whole leaves: the
  split leaves' sums are summed over 'model', the whole ones counted once."""
  if state.mesh is None:
    return torch.sqrt(sum(values))
  dims = params_lib.tree_leaves(state.dims)
  whole = sum(v for v, d in zip(values, dims) if d is None)
  split = sum(v for v, d in zip(values, dims) if d is not None)
  return torch.sqrt(whole + partitioning.all_reduce(
      torch.as_tensor(split, device=values[0].device), state.mesh,
      partitioning.MODEL_AXIS))


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
               seed: int, model_config: ModelConfig, run_config: RunConfig,
               num_microbatches: int = 0
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
  """One training step: forward, summed loss, grads, Adafactor update.

  `batch` holds model features on the parameters' device (on a mesh, the
  rank's rows).  Updates `state` in place and returns it with 0-d tensor
  metrics.
  num_microbatches > 1 accumulates gradients over sequential slices of
  the batch (each slice draws the step's dropout masks, as in the JAX
  package); the metrics are the last slice's.
  Spans (utils/profiling): 'train.step' around the step; inside it the
  device spans 'train.forward' (forward and loss), 'train.backward' (a
  pair per slice) and 'train.optimizer' (the data sum, grad_norm,
  Adafactor and param_norm).
  """
  leaves = params_lib.tree_leaves(state.params)
  device = leaves[0].device
  for p in leaves:
    p.grad = None

  def generator():
    return (dropout_generator(seed, state.step)
            if model_config.dropout_rate > 0 else None)

  def forward_backward(rows):
    with profiling.span('train.forward', device=device):
      total, metrics = _loss_and_metrics(state.params, rows, model_config,
                                         run_config, generator(), state.mesh)
    with profiling.span('train.backward', device=device):
      total.backward()
    return metrics

  with profiling.span('train.step'):
    if num_microbatches and num_microbatches > 1:
      batch_size = batch['decoder_target_tokens'].shape[0]
      if batch_size % num_microbatches:
        raise ValueError('batch size not divisible by num_microbatches')
      micro = batch_size // num_microbatches
      for i in range(num_microbatches):
        metrics = forward_backward(
            {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()})
    else:
      metrics = forward_backward(batch)

    with profiling.span('train.optimizer', device=device):
      lr = create_learning_rate_fn(run_config)(state.step)
      with torch.no_grad():
        if state.mesh is not None:
          _sum_grads_over_data(leaves, state.mesh)
        grad_norm = _norm([torch.sum(torch.square(p.grad.float()))
                           for p in leaves], state)
      for group in state.optimizer.param_groups:
        group['lr'] = lr
      state.optimizer.step()
      with torch.no_grad():
        metrics['learning_rate'] = torch.tensor(lr, dtype=torch.float32)
        metrics['grad_norm'] = grad_norm
        metrics['param_norm'] = _norm([torch.sum(torch.square(p))
                                       for p in leaves], state)
    for p in leaves:
      p.grad = None
    state.step += 1
  return state, metrics


_STATS = ('v_row', 'v_col', 'v_full')


def _stat_dims(state: TrainState) -> Dict[str, params_lib.Tree]:
  """For each Adafactor statistic, the tree of its dimension split over
  'model': v_full follows the leaf; of a factored leaf's two factors, the
  one along the split dimension is split along its last dimension."""
  def dims(p, dim, _):
    if dim is None:
      return dict.fromkeys(_STATS)
    if adafactor.factored(params_lib.global_shape(p.shape, dim, state.mesh)):
      return {'v_row': -1 if dim == -2 else None,
              'v_col': -1 if dim == -1 else None, 'v_full': None}
    return {'v_row': None, 'v_col': None, 'v_full': dim}
  return {name: params_lib.map_with_dims(
      lambda p, dim, path, n=name: dims(p, dim, path)[n], state.params,
      state.dims) for name in _STATS}


def state_tree(state: TrainState) -> dict:
  """The train state as a tree shaped like the JAX package's TrainState:
  {'step', 'params', 'opt_state': {'v_row', 'v_col', 'v_full'}}, each
  optimizer statistic a tree shaped like the parameters.  On a mesh the
  full tree, gathered on the host (a collective: every rank calls it)."""
  opt = state.optimizer.state

  def stat(name):
    return params_lib.tree_map(lambda p: opt[p][name], state.params)
  tree = {'step': state.step,
          'params': params_lib.tree_map(lambda p: p.detach(), state.params),
          'opt_state': {name: stat(name) for name in _STATS}}
  if state.mesh is None:
    return tree
  host = params_lib.tree_map(lambda t: t.detach().to('cpu'), tree['params'])
  stat_dims = _stat_dims(state)
  return {'step': state.step,
          'params': params_lib.gather_tree(host, state.dims, state.mesh),
          'opt_state': {name: params_lib.gather_tree(
              params_lib.tree_map(lambda t: t.to('cpu'),
                                  tree['opt_state'][name]),
              stat_dims[name], state.mesh) for name in _STATS}}


def load_state_tree(state: TrainState, tree: Mapping[str, Any]) -> None:
  """Copy a state_tree (torch or numpy leaves, e.g. a JAX TrainState's
  np.asarray'd leaves) into `state` in place; on a mesh, a full tree, of
  which the rank keeps its shards."""
  step = int(np.asarray(tree['step']))
  params_lib.check_structure(tree['params'], state.params, 'params')
  for name in _STATS:
    params_lib.check_structure(tree['opt_state'][name], state.params,
                               f'opt_state {name}')

  def tensors(t):
    return params_lib.tree_map(
        lambda x: x if torch.is_tensor(x) else torch.from_numpy(np.array(x)),
        t)
  new_params = tensors(tree['params'])
  new_stats = {name: tensors(tree['opt_state'][name]) for name in _STATS}
  for new, p, dim in zip(params_lib.tree_leaves(new_params),
                         params_lib.tree_leaves(state.params),
                         params_lib.tree_leaves(state.dims) if state.dims
                         else itertools.repeat(None)):
    _check_shape(new, params_lib.global_shape(p.shape, dim, state.mesh))
  if state.mesh is not None:
    new_params = params_lib.shard_tree(new_params, state.dims, state.mesh)
    stat_dims = _stat_dims(state)
    new_stats = {name: params_lib.shard_tree(new_stats[name],
                                             stat_dims[name], state.mesh)
                 for name in _STATS}
  leaves = params_lib.tree_leaves(state.params)
  new_params = params_lib.tree_leaves(new_params)
  stats = {name: params_lib.tree_leaves(new_stats[name]) for name in _STATS}
  with torch.no_grad():
    for i, p in enumerate(leaves):
      p.copy_(new_params[i])
      slot = state.optimizer.state[p]
      slot['step'] = step
      for name, values in stats.items():
        value = values[i]
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
  JAX train step computes the spectrogram inside the step.  A host span
  'train.batch' (utils/profiling).
  """
  def put(name, dtype):
    return torch.as_tensor(np.asarray(batch[name])).to(device, dtype)
  with profiling.span('train.batch'):
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
  thread, so its transfer and log-mel overlap the previous step; on a
  mesh, only the rank's rows of it (partitioning.shard_batch).  close()
  stops the producer before it draws another batch and drains the queue,
  so the thread exits; `staged` counts the batches made until then.
  """

  def __init__(self, batches: Iterator, spectrogram_config: SpectrogramConfig,
               device, mesh: Optional[Mesh] = None):
    from mt3_tpu_torch.data import pipeline
    self.staged = 0
    self._stop = threading.Event()

    def until_stopped():
      while not self._stop.is_set():
        yield next(batches)

    def stage(batch):
      self.staged += 1
      return model_batch(partitioning.shard_batch(batch, mesh),
                         spectrogram_config, device)

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
  """Holds the train state on one device, or this rank's shards of it on
  a mesh (the mesh's device), and steps it."""
  model_config: ModelConfig
  run_config: RunConfig
  mesh: Optional[Mesh] = None
  seed: int = 0
  num_microbatches: int = 0
  device: Any = None

  def __post_init__(self):
    self.device = (self.mesh.device if self.mesh is not None
                   else resolve_device(self.device))
    self._async_saver = None
    generator = torch.Generator().manual_seed(self.seed)
    self.state = init_train_state(self.model_config, generator, self.device,
                                  mesh=self.mesh)

  def shard_batch(self, batch):
    """This rank's rows of a global batch (the batch itself without a
    mesh)."""
    return partitioning.shard_batch(batch, self.mesh)

  def step(self, batch) -> Dict[str, torch.Tensor]:
    """One step on a batch of model features (numpy arrays or tensors):
    on a mesh, this process's rows of the global batch (shard_batch), as
    the JAX package's step takes each process's slice."""
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
    finalize_saves() before exiting).  On a mesh every rank calls it: the
    shards are gathered, global rank 0 writes the full tree and the others
    wait for it at a barrier (for an asynchronous save, in the next save
    or finalize_saves()).
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

  def full_params(self) -> params_lib.Tree:
    """The whole parameter tree (on a mesh gathered on the host: every
    rank calls it)."""
    return state_tree(self.state)['params']

  def load_params(self, params) -> None:
    """Warm-start from a (full) parameter tree: fresh optimizer, step
    kept.  Raises ValueError, before anything changes, on a tree whose key
    paths or shapes differ from the model's."""
    params_lib.check_structure(params, self.state.params, 'params')
    dims = (params_lib.tree_leaves(self.state.dims) if self.state.dims
            else itertools.repeat(None))
    for new, old, dim in zip(params_lib.tree_leaves(params),
                             params_lib.tree_leaves(self.state.params), dims):
      _check_shape(new, params_lib.global_shape(old.shape, dim, self.mesh))
    step = self.state.step
    self.state = init_train_state(
        self.model_config, device=self.device,
        params=params_lib.tree_map(torch.as_tensor, params), mesh=self.mesh)
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


def _check_shape(new, shape):
  if tuple(np.shape(new)) != tuple(shape):
    raise ValueError(f'shape mismatch {np.shape(new)} vs {tuple(shape)}')


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
