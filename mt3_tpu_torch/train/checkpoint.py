"""Checkpoints: the port's own train states, and the JAX package's and T5X's
parameters.

The port's train states: one file, <directory>/checkpoint_<step>.pt,
written with torch.save: trainer.state_tree (step, parameters, Adafactor
statistics), at once or, through AsyncCheckpointSaver, on a writer thread
from a host snapshot taken before the save returns.  Restart semantics
follow the reference: dataset state is not saved, and training resumes
from the latest step with a fresh data pipeline.  A train state on a mesh
is saved as the same file: the full tree, gathered from the shards
(trainer.state_tree) and written by global rank 0 while the other ranks
wait at a barrier, as orbax writes global arrays; restoring reads the full
tree on every rank, which keeps its shards.

The JAX package's checkpoints: <directory>/checkpoint_<step>/, written by
orbax's StandardCheckpointer as an OCDBT key-value store of zarr arrays.
restore_params reads their parameters (the params-only restore of
mt3_tpu/train/checkpoint.py:restore_checkpoint) through tensorstore, the
one package that reads that store.  tensorstore is imported only inside
_read_tensorstore, and only where a checkpoint needs it.

Published T5X checkpoints: t5x_loader.load_t5x_params, then
convert_t5x_param_dict below (a copy of the JAX package's).
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Optional

import numpy as np
import torch

from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.parallel import partitioning
from mt3_tpu_torch.train import trainer as trainer_lib

PyTree = Any

_NAME = re.compile(r'^checkpoint_(\d+)(\.pt)?$')


def _checkpoint_path(directory: str, step: int) -> str:
  directory = os.path.abspath(directory)
  os.makedirs(directory, exist_ok=True)
  return os.path.join(directory, f'checkpoint_{step}.pt')


def _write(path: str, tree: dict) -> None:
  """torch.save to a temporary name, then rename: latest_checkpoint never
  sees a half-written file."""
  tmp = path + '.tmp'
  torch.save(tree, tmp)
  os.replace(tmp, path)


def _writes(state: 'trainer_lib.TrainState') -> bool:
  """Whether this process writes the state's checkpoints."""
  return state.mesh is None or state.mesh.is_chief


def save_checkpoint(directory: str, state: 'trainer_lib.TrainState') -> str:
  """Write the train state; returns the checkpoint's path.  On a mesh,
  every rank calls it and returns once rank 0 has written the file."""
  tree = trainer_lib.state_tree(state)
  path = _checkpoint_path(directory, state.step)
  if _writes(state):
    _write(path, tree)
  partitioning.barrier(state.mesh)
  return path


def _host_snapshot(state: 'trainer_lib.TrainState') -> dict:
  """The train state's tree with every tensor copied to host memory.

  The train step updates parameters and Adafactor statistics in place, so
  an asynchronous save must copy them before the next step runs.  The
  copies are made here, on the caller's thread: a copy from the card waits
  for the work queued before it, and returns once the data is on the host.
  """
  return params_lib.tree_map(
      lambda leaf: (leaf.detach().to('cpu', copy=True)
                    if torch.is_tensor(leaf) else leaf),
      trainer_lib.state_tree(state))


class AsyncCheckpointSaver:
  """Non-blocking checkpoint saves (training overlaps the write).

  Counterpart of mt3_tpu/train/checkpoint.py's AsyncCheckpointSaver (orbax's
  AsyncCheckpointer): save() takes a host snapshot of the state before it
  returns, then writes the file on a thread.  A new save waits for the one
  before it, as orbax's does; wait() blocks until the last one is written
  and raises what a writer raised.  On a mesh every rank calls save() and
  wait(): the snapshot is the gathered full tree, rank 0 alone writes it,
  and wait() holds every rank at a barrier until the file is written.
  """

  def __init__(self):
    self._thread: Optional[threading.Thread] = None
    self._error: Optional[BaseException] = None
    self._mesh = None   # the mesh of a pending save, waited for at a barrier

  def save(self, directory: str, state: 'trainer_lib.TrainState') -> str:
    self.wait()
    path = _checkpoint_path(directory, state.step)
    tree = _host_snapshot(state)
    self._mesh = state.mesh
    if not _writes(state):
      return path

    def write():
      try:
        _write(path, tree)
      except BaseException as e:  # re-raised by wait()
        self._error = e

    self._thread = threading.Thread(target=write, name='checkpoint-writer',
                                    daemon=True)
    self._thread.start()
    return path

  def wait(self) -> None:
    if self._thread is not None:
      self._thread.join()
      self._thread = None
    if self._mesh is not None:
      mesh, self._mesh = self._mesh, None
      partitioning.barrier(mesh)
    if self._error is not None:
      error, self._error = self._error, None
      raise error


def latest_checkpoint(directory: str) -> Optional[str]:
  """The checkpoint of the highest step in `directory`, or None.

  Both formats count: the port's checkpoint_<step>.pt files and the JAX
  package's checkpoint_<step>/ directories (at one step, the .pt file).
  """
  directory = os.path.abspath(directory)
  if not os.path.isdir(directory):
    return None
  found = [(int(m.group(1)), bool(m.group(2)), name)
           for name, m in ((n, _NAME.match(n)) for n in os.listdir(directory))
           if m]
  if not found:
    return None
  return os.path.join(directory, max(found)[2])


def restore_checkpoint(path: str, state: 'trainer_lib.TrainState') -> None:
  """Load a checkpoint written by save_checkpoint into `state` in place."""
  if os.path.isdir(path):
    raise ValueError(
        f'{path} is a directory: a whole train state resumes only from the '
        "port's checkpoint_<step>.pt files; restore_params reads the "
        'parameters of a JAX package checkpoint')
  if not os.path.isfile(path):
    raise FileNotFoundError(f'no checkpoint at {path}')
  tree = torch.load(path, map_location='cpu', weights_only=True)
  trainer_lib.load_state_tree(state, tree)


def restore_params(path: str, template: params_lib.Tree) -> params_lib.Tree:
  """The parameter tree of a checkpoint, as float32 tensors on the CPU.

  `path` is a checkpoint_<step>.pt file of the port or a checkpoint_<step>/
  directory of the JAX package (orbax).  The tree must have the key paths
  and shapes of `template` (ValueError otherwise).
  """
  if os.path.isfile(path):
    params = torch.load(path, map_location='cpu', weights_only=True)['params']
  elif os.path.isfile(os.path.join(path, '_METADATA')):
    params = params_lib.from_numpy_tree(_read_orbax_params(path))
  else:
    raise FileNotFoundError(f'no checkpoint at {path}')
  params_lib.check_structure(params, template, 'params')
  for new, old in zip(params_lib.tree_leaves(params),
                      params_lib.tree_leaves(template)):
    if tuple(new.shape) != tuple(old.shape):
      raise ValueError(f'shape mismatch {tuple(new.shape)} vs '
                       f'{tuple(old.shape)}')
  return params_lib.tree_map(
      lambda t: t.detach().to('cpu', torch.float32), params)


def load_params(checkpoint: str, model_config) -> tuple:
  """(parameter tree, path) of the latest checkpoint in the directory
  `checkpoint`, or of the checkpoint at that path, checked against a tree
  of `model_config`'s shapes."""
  path = latest_checkpoint(checkpoint) or checkpoint
  return restore_params(path, params_lib.init_params(model_config)), path


def _read_orbax_params(path: str) -> dict:
  """The 'params' subtree of an orbax StandardCheckpointer directory, as
  numpy float32 leaves.  The leaves' key paths are listed in _METADATA;
  each is a zarr array under its dotted path in the OCDBT store."""
  path = os.path.abspath(path)
  with open(os.path.join(path, '_METADATA')) as f:
    metadata = json.load(f)
  if metadata.get('use_zarr3') or not metadata.get('use_ocdbt', True):
    raise ValueError(f'{path}: only OCDBT stores of zarr v2 arrays are read '
                     "(orbax's defaults, as the JAX package writes them)")
  tree = {}
  for entry in metadata['tree_metadata'].values():
    keys = [str(k['key']) for k in entry['key_metadata']]
    if keys[0] != 'params':
      continue
    node = tree
    for key in keys[1:-1]:
      node = node.setdefault(key, {})
    node[keys[-1]] = _read_tensorstore({
        'driver': 'zarr',
        'kvstore': {'driver': 'ocdbt', 'base': f'file://{path}',
                    'path': '.'.join(keys)}})
  if not tree:
    raise ValueError(f'no params in the checkpoint at {path}')
  return tree


def _read_tensorstore(spec: dict) -> np.ndarray:
  """Read a TensorStore spec as a float32 array (bf16 widened)."""
  try:
    import tensorstore
  except ImportError as e:
    raise ImportError(
        'reading this checkpoint needs the tensorstore package, which is '
        'not installed: orbax OCDBT stores (and blosc-compressed zarr '
        'chunks) have no other reader') from e
  array = tensorstore.open(spec, read=True).result().read().result()
  return np.asarray(array).astype(np.float32)


# ---------------------------------------------------------------------------
# T5X published-checkpoint conversion.
# ---------------------------------------------------------------------------
# Mapping from t5x parameter paths (as found in published MT3 checkpoints,
# e.g. gs://mt3/checkpoints/mt3/) to our parameter tree.  t5x DenseGeneral
# kernels are already stored flattened 2-D (reference layers.py:406-415),
# matching our layout, so conversion is renaming + per-layer stacking.
#
# t5x path template -> (our section, our leaf)
_T5X_ENCODER_LAYER = {
    'attention/query/kernel': ('attention', 'query'),
    'attention/key/kernel': ('attention', 'key'),
    'attention/value/kernel': ('attention', 'value'),
    'attention/out/kernel': ('attention', 'out'),
    'pre_attention_layer_norm/scale': ('pre_attention_norm',),
    'mlp/wi_0/kernel': ('mlp', 'wi_0'),
    'mlp/wi_1/kernel': ('mlp', 'wi_1'),
    'mlp/wo/kernel': ('mlp', 'wo'),
    'pre_mlp_layer_norm/scale': ('pre_mlp_norm',),
}
_T5X_DECODER_LAYER = {
    'self_attention/query/kernel': ('self_attention', 'query'),
    'self_attention/key/kernel': ('self_attention', 'key'),
    'self_attention/value/kernel': ('self_attention', 'value'),
    'self_attention/out/kernel': ('self_attention', 'out'),
    'pre_self_attention_layer_norm/scale': ('pre_self_attention_norm',),
    'encoder_decoder_attention/query/kernel': ('cross_attention', 'query'),
    'encoder_decoder_attention/key/kernel': ('cross_attention', 'key'),
    'encoder_decoder_attention/value/kernel': ('cross_attention', 'value'),
    'encoder_decoder_attention/out/kernel': ('cross_attention', 'out'),
    'pre_cross_attention_layer_norm/scale': ('pre_cross_attention_norm',),
    'mlp/wi_0/kernel': ('mlp', 'wi_0'),
    'mlp/wi_1/kernel': ('mlp', 'wi_1'),
    'mlp/wo/kernel': ('mlp', 'wo'),
    'pre_mlp_layer_norm/scale': ('pre_mlp_norm',),
}


def convert_t5x_param_dict(t5x_params: dict, num_encoder_layers: int,
                           num_decoder_layers: int) -> dict:
  """Convert a flat {t5x_path: array} dict to our parameter pytree.

  `t5x_params` keys are slash-joined paths under 'target', e.g.
  'encoder/layers_0/attention/query/kernel'.  Per-layer weights are stacked
  along a leading layer axis to match the lax.scan layout.
  """
  def get(path):
    if path not in t5x_params:
      import difflib
      close = difflib.get_close_matches(path, t5x_params, n=3, cutoff=0.5)
      hint = f'; closest available: {close}' if close else ''
      raise KeyError(
          f'missing t5x param: {path!r} '
          f'({len(t5x_params)} params in checkpoint{hint}; check '
          'num_encoder_layers/num_decoder_layers match the checkpoint)')
    return np.asarray(t5x_params[path])

  def set_leaf(tree, key_path, value):
    node = tree
    for k in key_path[:-1]:
      node = node.setdefault(k, {})
    node[key_path[-1]] = value

  def stack_layers(prefix, table, num_layers):
    out = {}
    collected = {tuple(ours): [] for ours in table.values()}
    for layer in range(num_layers):
      for t5x_rel, ours in table.items():
        collected[tuple(ours)].append(
            get(f'{prefix}/layers_{layer}/{t5x_rel}'))
    for ours, arrays in collected.items():
      set_leaf(out, ours, np.stack(arrays))
    return out

  params = {
      'encoder': {
          'input_proj': get('encoder/continuous_inputs_projection/kernel'),
          'layers': stack_layers('encoder', _T5X_ENCODER_LAYER,
                                 num_encoder_layers),
          'norm': get('encoder/encoder_norm/scale'),
      },
      'decoder': {
          'token_embed': get('decoder/token_embedder/embedding'),
          'layers': stack_layers('decoder', _T5X_DECODER_LAYER,
                                 num_decoder_layers),
          'norm': get('decoder/decoder_norm/scale'),
          'logits': get('decoder/logits_dense/kernel'),
      },
  }
  return params


def flatten_params(params: PyTree, prefix: str = '') -> dict:
  """Flatten a nested param dict to {slash/path: leaf}."""
  out = {}
  for key, value in params.items():
    path = f'{prefix}/{key}' if prefix else key
    if isinstance(value, dict):
      out.update(flatten_params(value, path))
    else:
      out[path] = value
  return out
