"""Parameter trees for the PyTorch port: the bridge from JAX and initialization.

The port's parameters are the JAX package's tree as nested dicts of torch
tensors, leaf for leaf: the same paths, the stacked [layers, ...] leaves
and the 2-D [in, out] dense kernels (mt3_tpu/models/layers.py), so
conversion is a copy with no transposes.

  from_numpy_tree  JAX tree (np.asarray'd leaves) -> torch tree
  to_numpy_tree    torch tree -> numpy tree
  tree_leaves      the leaves in JAX's flattening order (sorted keys)
  tree_paths, check_structure  their dotted key paths, and a check that
                   two trees have the same ones
  init_params      a fresh tree drawn with torch at the JAX initializers'
                   distributions (the values differ from JAX's)
  convert_mha_to_gqa  mean-pool K/V projection heads (a warm start for a
                   grouped-query finetune)

Checkpoints are read into this tree by train/checkpoint.py (the port's
own and the JAX package's orbax ones) and train/t5x_loader.py (T5X).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from mt3_tpu_torch.core.config import ModelConfig

Tree = Dict[str, Any]

def tree_map(fn: Callable, tree):
  if isinstance(tree, dict):
    return {k: tree_map(fn, v) for k, v in tree.items()}
  return fn(tree)


def tree_leaves(tree) -> list:
  """Leaves in jax.tree_util's order for dicts: keys sorted at every level."""
  if isinstance(tree, dict):
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
  return [tree]


def tree_paths(tree, prefix: str = '') -> list:
  """Dotted key paths of the leaves, in tree_leaves' order."""
  if isinstance(tree, dict):
    return [path for k in sorted(tree)
            for path in tree_paths(tree[k], f'{prefix}{k}.')]
  return [prefix[:-1]]


def check_structure(new, old, what: str = 'tree') -> None:
  """Raise ValueError unless `new` has exactly the key paths of `old`,
  naming the missing and the extra ones (as jax.tree_util.tree_map fails
  on trees of different structure)."""
  new_paths, old_paths = set(tree_paths(new)), set(tree_paths(old))
  if new_paths != old_paths:
    missing = sorted(old_paths - new_paths)
    extra = sorted(new_paths - old_paths)
    raise ValueError(f'{what} structure differs: missing {missing}, '
                     f'extra {extra}')


def from_numpy_tree(tree, device='cpu', dtype=torch.float32) -> Tree:
  """Copy a tree of numpy (or np.asarray-able) leaves into torch tensors."""
  return tree_map(
      lambda leaf: torch.tensor(np.asarray(leaf), dtype=dtype, device=device),
      tree)


def to_numpy_tree(tree: Tree) -> Tree:
  return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def to_device(tree: Tree, device) -> Tree:
  return tree_map(lambda t: t.to(device), tree)


def layer(stacked: Tree, index: int) -> Tree:
  """Slice layer `index` out of a stacked [layers, ...] subtree (views)."""
  return tree_map(lambda t: t[index], stacked)


# ---------------------------------------------------------------------------
# Initialization at the JAX initializers' distributions (layers.py:34-45).
# ---------------------------------------------------------------------------
# jax variance_scaling(..., 'truncated_normal'): std / this, cut at +-2 std.
_TRUNCATED_NORMAL_STD = 0.87962566103423978


def _dense(generator, shape, num_layers=None, scale=1.0):
  """Truncated normal, fan-in variance 1: dense_init of each [in, out]."""
  full = shape if num_layers is None else (num_layers,) + shape
  std = math.sqrt(1.0 / shape[0]) / _TRUNCATED_NORMAL_STD
  t = torch.empty(full, dtype=torch.float32)
  torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
  return t * scale


def _attention(generator, config: ModelConfig, num_layers: int) -> Tree:
  joined = config.num_heads * config.head_dim
  joined_kv = config.kv_heads * config.head_dim
  emb = config.emb_dim
  return {
      'query': _dense(generator, (emb, joined), num_layers,
                      scale=1.0 / np.sqrt(config.head_dim)),
      'key': _dense(generator, (emb, joined_kv), num_layers),
      'value': _dense(generator, (emb, joined_kv), num_layers),
      'out': _dense(generator, (joined, emb), num_layers),
  }


def _mlp(generator, config: ModelConfig, num_layers: int) -> Tree:
  emb, mlp = config.emb_dim, config.mlp_dim
  names = (['wi'] if len(config.mlp_activations) == 1 else
           [f'wi_{i}' for i in range(len(config.mlp_activations))])
  tree = {name: _dense(generator, (emb, mlp), num_layers) for name in names}
  tree['wo'] = _dense(generator, (mlp, emb), num_layers)
  return tree


def init_params(config: ModelConfig,
                generator: Optional[torch.Generator] = None,
                device='cpu') -> Tree:
  """The model's parameter tree, drawn on the CPU from `generator`."""
  if generator is None:
    generator = torch.Generator().manual_seed(0)
  emb = config.emb_dim
  n_enc, n_dec = config.num_encoder_layers, config.num_decoder_layers

  def ones(num_layers=None):
    shape = (emb,) if num_layers is None else (num_layers, emb)
    return torch.ones(shape, dtype=torch.float32)

  tree = {
      'encoder': {
          'input_proj': _dense(generator, (config.input_depth, emb)),
          'layers': {
              'attention': _attention(generator, config, n_enc),
              'pre_attention_norm': ones(n_enc),
              'mlp': _mlp(generator, config, n_enc),
              'pre_mlp_norm': ones(n_enc),
          },
          'norm': ones(),
      },
      'decoder': {
          'token_embed': torch.randn(
              (config.vocab_size, emb), generator=generator),
          'layers': {
              'self_attention': _attention(generator, config, n_dec),
              'pre_self_attention_norm': ones(n_dec),
              'cross_attention': _attention(generator, config, n_dec),
              'pre_cross_attention_norm': ones(n_dec),
              'mlp': _mlp(generator, config, n_dec),
              'pre_mlp_norm': ones(n_dec),
          },
          'norm': ones(),
          'logits': _dense(generator, (emb, config.vocab_size)),
      },
  }
  return to_device(tree, device)


# ---------------------------------------------------------------------------
# Checkpoint surgery (mt3_tpu/train/checkpoint.py:convert_mha_to_gqa).
# ---------------------------------------------------------------------------
def convert_mha_to_gqa(params: Tree, num_heads: int, head_dim: int,
                       num_kv_heads: int,
                       allow_unfinetuned: bool = False) -> Tree:
  """Mean-pool each attention's K/V projection heads to num_kv_heads.

  Each group of num_heads // num_kv_heads adjacent K/V heads is averaged
  (query head h then reads K/V head h // group, as decode and training
  group them); query and output projections are untouched.  Works on
  every attention dict of the tree (one with 'query', 'key' and 'value'),
  stacked [L, emb, h*d] or not.

  The JAX package measured that mean-pooling alone collapses quality
  (onset F1 0.014 against 0.419, TRAINING.md) and that the result needs a
  recovery finetune, so this raises unless allow_unfinetuned=True: pass it
  only before such a finetune or to measure the unfinetuned conversion.
  """
  if not allow_unfinetuned:
    raise ValueError(
        'convert_mha_to_gqa produces a warm-start checkpoint that is '
        'unusable without a recovery finetune (onset F1 collapses to '
        '~0.01; TRAINING.md).  Finetune it with --gqa_kv_heads N, or pass '
        'allow_unfinetuned=True if you are about to finetune or are '
        'deliberately measuring the unfinetuned conversion.')
  if num_heads % num_kv_heads:
    raise ValueError(f'{num_heads} heads not divisible by '
                     f'{num_kv_heads} KV heads')
  group = num_heads // num_kv_heads

  def pool(kernel: torch.Tensor) -> torch.Tensor:
    *lead, joined = kernel.shape
    if joined != num_heads * head_dim:
      raise ValueError(f'K/V kernel trailing dim {joined} != '
                       f'{num_heads} heads x {head_dim}')
    grouped = kernel.reshape(*lead, num_kv_heads, group, head_dim)
    return grouped.mean(dim=-2).reshape(*lead, num_kv_heads * head_dim)

  def walk(node):
    if isinstance(node, dict):
      if 'query' in node and 'key' in node and 'value' in node:
        return {**node, 'key': pool(node['key']),
                'value': pool(node['value'])}
      return {k: walk(v) for k, v in node.items()}
    return node

  return walk(params)
