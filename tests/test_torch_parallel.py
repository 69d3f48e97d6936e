"""The port's partitioning against mt3_tpu/parallel, in one process.

  * DEFAULT_RULES and logical_to_spec equal JAX's, entry for entry;
  * params.param_axes(config) equals the axes tree of JAX's t5.init_params,
    for multi-head and grouped-query attention;
  * shard_tree's blocks, one per model rank, join into the full tree;
    a split dimension that does not divide by the model size raises
    ValueError naming the leaf;
  * head_layout and model_dims: whole heads a rank; K/V kernels split with
    their heads where the K/V heads divide by the model size, replicated
    (each rank reading its query heads' K/V heads) where they do not;
  * the hybrid mesh's checks (multihost.check_hybrid);
  * a mesh of one (no process group, so every collective is the identity)
    computes encode, decode_step and a train step's loss and gradients bit
    for bit as mesh=None, with dropout live: the model-parallel code paths
    (the masked embedding lookup, the input projection's feature block, the
    global dropout draws) reduce exactly to the single-device ones.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu.parallel import partitioning as jax_partitioning
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config
from mt3_tpu_torch.models import t5
from mt3_tpu_torch.parallel import multihost, partitioning

torch.set_num_threads(2)


def _mesh(data=1, model=1, data_index=0, model_index=0):
  groups = dict.fromkeys(('data', 'model', 'world'))
  return partitioning.Mesh((data, model), data_index, model_index,
                           torch.device('cpu'), groups, groups)


def _is_axes(x):
  return isinstance(x, tuple) and all(isinstance(e, str) for e in x)


def test_rules_and_specs_equal_jax():
  assert partitioning.DEFAULT_RULES == jax_partitioning.DEFAULT_RULES
  assert (partitioning.DATA_AXIS, partitioning.MODEL_AXIS) == (
      jax_partitioning.DATA_AXIS, jax_partitioning.MODEL_AXIS)
  _, axes = jax_t5.init_params(jax.random.PRNGKey(0),
                               jax_config.tiny_config().model)
  for leaf in jax.tree_util.tree_leaves(axes, is_leaf=_is_axes):
    assert partitioning.logical_to_spec(leaf) == tuple(
        jax_partitioning.logical_to_spec(leaf))
  with pytest.raises(ValueError, match='no partitioning rule'):
    partitioning.logical_to_spec(('nope',))


@pytest.mark.parametrize('kv_heads', (None, 1, 2))
def test_param_axes_equal_jax(kv_heads):
  jax_model = dataclasses.replace(jax_config.tiny_config().model,
                                  num_kv_heads=kv_heads)
  _, want = jax_t5.init_params(jax.random.PRNGKey(0), jax_model)
  model = dataclasses.replace(config.tiny_config().model,
                              num_kv_heads=kv_heads)
  got = params_lib.param_axes(model)
  assert got == jax.tree_util.tree_map(lambda a: a, want, is_leaf=_is_axes)
  # The same key paths as the parameter tree.
  params_lib.check_structure(got, params_lib.init_params(model), 'axes')


@pytest.mark.parametrize('kv_heads,model_size', ((None, 2), (None, 4),
                                                 (1, 2), (2, 2)))
def test_shards_join_into_the_full_tree(kv_heads, model_size):
  model = dataclasses.replace(config.tiny_config().model,
                              num_kv_heads=kv_heads)
  full = params_lib.init_params(model)
  axes = params_lib.param_axes(model)
  blocks = []
  for index in range(model_size):
    mesh = _mesh(model=model_size, model_index=index)
    dims = partitioning.model_dims(axes, mesh, model)
    blocks.append(params_lib.shard_tree(full, dims, mesh))
  dims = params_lib.tree_leaves(dims)
  for leaf, dim, *parts in zip(params_lib.tree_leaves(full), dims,
                               *map(params_lib.tree_leaves, blocks)):
    if dim is None:
      assert all(torch.equal(p, leaf) for p in parts)
    else:
      assert parts[0].shape[dim] * model_size == leaf.shape[dim]
      assert torch.equal(torch.cat(parts, dim=dim), leaf)
      assert parts[0].is_contiguous()


def test_non_dividing_leaf_raises():
  model = config.tiny_config().model     # 4 heads, vocab 1536, mlp 32
  full = params_lib.init_params(model)
  mesh = _mesh(model=2)
  dims = partitioning.model_dims(params_lib.param_axes(model), mesh, model)
  full['decoder']['mlp_odd'] = torch.zeros(3, 5)
  dims['decoder']['mlp_odd'] = -1
  with pytest.raises(ValueError, match='decoder.mlp_odd'):
    params_lib.shard_tree(full, dims, mesh)


@pytest.mark.parametrize('heads,kv,model,want', (
    (6, None, 2, (3, 3, None)),
    (6, 6, 3, (2, 2, None)),
    (6, 2, 2, (3, 1, None)),
    (6, 1, 2, (3, 1, (0, 64))),
    (4, 1, 2, (2, 1, (0, 64))),
    (4, 2, 4, (1, 1, (0, 64))),
))
def test_head_layout(heads, kv, model, want):
  mesh = _mesh(model=model)
  layout = partitioning.head_layout(heads, kv, 64, mesh)
  columns = layout.kv_columns
  assert (layout.heads, layout.kv_heads,
          columns and (columns.start, columns.stop)) == want
  if kv is not None and kv % model:
    # The last model rank reads the last K/V head its query heads use.
    last = partitioning.head_layout(heads, kv, 64, _mesh(
        model=model, model_index=model - 1)).kv_columns
    group = heads // kv
    head = (model - 1) * (heads // model) // group
    assert (last.start, last.stop) == (head * 64, (head + 1) * 64)


def test_head_layout_refuses_split_heads_and_groups():
  with pytest.raises(ValueError, match='attention heads'):
    partitioning.head_layout(6, None, 64, _mesh(model=4))
  with pytest.raises(ValueError, match='groups'):
    partitioning.head_layout(6, 3, 64, _mesh(model=2))


def test_model_dims_keep_undivided_kv_replicated():
  model = dataclasses.replace(config.mt3_config().model, num_kv_heads=1)
  dims = partitioning.model_dims(params_lib.param_axes(model),
                                 _mesh(model=2), model)
  attention = dims['decoder']['layers']['self_attention']
  assert attention == {'query': -1, 'key': None, 'value': None, 'out': -2}
  assert dims['encoder']['input_proj'] == -2
  assert dims['decoder']['logits'] == -1
  assert dims['decoder']['token_embed'] == -2
  assert dims['decoder']['layers']['mlp'] == {'wi_0': -1, 'wi_1': -1,
                                              'wo': -2}
  assert dims['decoder']['norm'] is None
  mha = config.mt3_config().model
  dims = partitioning.model_dims(params_lib.param_axes(mha), _mesh(model=2),
                                 mha)
  assert dims['encoder']['layers']['attention']['key'] == -1


def test_check_hybrid():
  multihost.check_hybrid(4, 2, 2, 2)
  multihost.check_hybrid(16, 8, 4, 2)
  with pytest.raises(ValueError, match='does not match'):
    multihost.check_hybrid(4, 2, 2, 4)
  with pytest.raises(ValueError, match='cut across nodes'):
    multihost.check_hybrid(6, 3, 2, 2)
  with pytest.raises(ValueError, match='do not fill'):
    multihost.check_hybrid(5, 2, 1, 2)


def test_single_process_mesh_is_one():
  mesh = partitioning.make_mesh(1, device='cpu')
  assert mesh.shape == (1, 1) and mesh.rank == 0 and mesh.is_chief
  with pytest.raises(ValueError, match='model partitions'):
    partitioning.make_mesh(2, device='cpu')
  multihost.initialize(num_processes=1)   # a no-op
  assert not torch.distributed.is_initialized()


def _model(**overrides):
  return dataclasses.replace(config.tiny_config().model, **overrides)


@pytest.mark.parametrize('overrides', (
    {}, dict(num_kv_heads=1, decode_kv_quantize=True, decode_kv_bits=4,
             decode_cross_kv_quantize=True, decode_cache_carry='stacked')))
def test_mesh_of_one_decodes_bit_for_bit(overrides):
  model = _model(**overrides)
  params = params_lib.init_params(model, torch.Generator().manual_seed(0))
  inputs = torch.from_numpy(np.random.RandomState(0).randn(
      2, 8, model.input_depth).astype(np.float32))
  mesh = _mesh()
  local = partitioning.shard_params(params, params_lib.param_axes(model),
                                    mesh, model)
  outs = []
  for p, m in ((params, None), (local, mesh)):
    with torch.inference_mode():
      encoded = t5.encode(p, model, inputs, mesh=m)
      state = t5.init_decode_state(p, model, encoded, 8, mesh=m)
      token = torch.zeros(2, dtype=torch.int32)
      logits = []
      for _ in range(4):
        step_logits, state = t5.decode_step(p, model, token, state, mesh=m)
        logits.append(step_logits)
        token = step_logits.argmax(-1).to(torch.int32)
    outs.append((encoded, torch.stack(logits), state.cache.key))
  for a, b in zip(*outs):
    assert torch.equal(a, b)


def test_mesh_of_one_trains_bit_for_bit():
  model = _model(dropout_rate=0.1)
  params = params_lib.init_params(model, torch.Generator().manual_seed(1))
  rng = np.random.RandomState(2)
  inputs = torch.from_numpy(rng.randn(2, 8, model.input_depth).astype(
      np.float32))
  targets = torch.from_numpy(rng.randint(3, model.vocab_size, (2, 6)))
  mesh = _mesh()
  grads = []
  for m in (None, mesh):
    p = params_lib.tree_map(lambda t: t.clone().requires_grad_(), params)
    logits = t5.forward(p, model, inputs, targets, targets,
                        generator=torch.Generator().manual_seed(3), mesh=m)
    logits.sum().backward()
    grads.append([logits.detach()] + [
        leaf.grad for leaf in params_lib.tree_leaves(p)])
  for a, b in zip(*grads):
    assert torch.equal(a, b)
