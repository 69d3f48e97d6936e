"""Loading into the PyTorch port: load_transcriber's arguments and the
structure checks of Trainer.load_params and trainer.load_state_tree.

* mt3_tpu_torch.load_transcriber takes mt3_tpu.load_transcriber's first
  three parameters in the same order, so a positional checkpoint
  directory reaches the checkpoint branch (which is not ported yet and
  raises NotImplementedError).
* A parameter tree or train state with a leaf missing or a leaf too many
  is refused at load with ValueError naming the path, as jax.tree_util's
  tree_map refuses trees of different structure in the JAX Trainer, and
  the state is left as it was.  An equal tree still loads.
"""

import inspect

import numpy as np
import pytest
import torch

import mt3_tpu
import mt3_tpu_torch
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config
from mt3_tpu_torch.train import trainer

torch.set_num_threads(2)


def test_load_transcriber_positional_parameters_match_jax():
  ours = list(inspect.signature(mt3_tpu_torch.load_transcriber).parameters)
  theirs = list(inspect.signature(mt3_tpu.load_transcriber).parameters)
  assert ours[:3] == theirs[:3] == ['model', 'checkpoint_dir', 'bfloat16']
  kinds = inspect.signature(mt3_tpu_torch.load_transcriber).parameters
  assert kinds['params'].kind is inspect.Parameter.KEYWORD_ONLY
  assert kinds['device'].kind is inspect.Parameter.KEYWORD_ONLY


def test_load_transcriber_positional_checkpoint_raises():
  with pytest.raises(NotImplementedError, match='checkpoints is not ported'):
    mt3_tpu_torch.load_transcriber('tiny', '/nonexistent', device='cpu')


def test_load_transcriber_params_by_keyword():
  tiny = config.tiny_config()
  params = params_lib.init_params(tiny.model,
                                  torch.Generator().manual_seed(4))
  t = mt3_tpu_torch.load_transcriber('tiny', None, False, params=params,
                                     device='cpu')
  assert t.device.type == 'cpu'
  for got, want in zip(params_lib.tree_leaves(t.params),
                       params_lib.tree_leaves(params)):
    assert torch.equal(got, want)


def _drop(tree, path):
  """A copy of tree without the leaf at dotted `path`."""
  tree = params_lib.tree_map(lambda x: x, tree)
  *parents, leaf = path.split('.')
  node = tree
  for key in parents:
    node = node[key]
  del node[leaf]
  return tree


def _add(tree, path, value):
  tree = params_lib.tree_map(lambda x: x, tree)
  *parents, leaf = path.split('.')
  node = tree
  for key in parents:
    node = node.setdefault(key, {})
  node[leaf] = value
  return tree


# (change, dotted path of the leaf missing or added)
CHANGES = [('missing', 'encoder.norm'), ('missing', 'decoder.layers.mlp.wo'),
           ('extra', 'encoder.extra_norm'),
           ('extra', 'decoder.layers.mlp.wi_2')]


def _changed(tree, change, path):
  if change == 'missing':
    return _drop(tree, path)
  return _add(tree, path, np.zeros(8, np.float32))


def _trainer():
  tiny = config.tiny_config()
  return trainer.Trainer(tiny.model, tiny.run, device='cpu')


@pytest.mark.parametrize('change,path', CHANGES)
def test_trainer_load_params_refuses_other_structure(change, path):
  tr = _trainer()
  before = [p.detach().clone() for p in params_lib.tree_leaves(tr.state.params)]
  fresh = params_lib.to_numpy_tree(params_lib.init_params(
      tr.model_config, torch.Generator().manual_seed(5)))
  bad = _changed(fresh, change, path)
  with pytest.raises(ValueError, match='params structure differs') as err:
    tr.load_params(bad)
  assert f"{change} ['{path}']" in str(err.value)
  for p, b in zip(params_lib.tree_leaves(tr.state.params), before):
    assert torch.equal(p.detach(), b)


def test_trainer_load_params_accepts_equal_structure():
  tr = _trainer()
  fresh = params_lib.init_params(tr.model_config,
                                 torch.Generator().manual_seed(6))
  tr.load_params(params_lib.to_numpy_tree(fresh))
  for p, w in zip(params_lib.tree_leaves(tr.state.params),
                  params_lib.tree_leaves(fresh)):
    assert torch.equal(p.detach(), w)


def _state_pair():
  tiny = config.tiny_config()
  a = trainer.init_train_state(tiny.model, torch.Generator().manual_seed(1),
                               'cpu')
  b = trainer.init_train_state(tiny.model, torch.Generator().manual_seed(2),
                               'cpu')
  return a, b


@pytest.mark.parametrize('part', ['params', 'v_row', 'v_full'])
@pytest.mark.parametrize('change,path', CHANGES)
def test_load_state_tree_refuses_other_structure(part, change, path):
  a, b = _state_pair()
  tree = trainer.state_tree(a)
  if part == 'params':
    tree['params'] = _changed(tree['params'], change, path)
  else:
    tree['opt_state'][part] = _changed(tree['opt_state'][part], change, path)
  before = [p.detach().clone() for p in params_lib.tree_leaves(b.params)]
  with pytest.raises(ValueError, match='structure differs') as err:
    trainer.load_state_tree(b, tree)
  assert f"{change} ['{path}']" in str(err.value)
  assert (part == 'params') == str(err.value).startswith('params')
  assert b.step == 0
  for p, w in zip(params_lib.tree_leaves(b.params), before):
    assert torch.equal(p.detach(), w)


def test_load_state_tree_accepts_equal_structure():
  a, b = _state_pair()
  trainer.load_state_tree(b, trainer.state_tree(a))
  for x, y in zip(params_lib.tree_leaves(trainer.state_tree(a)),
                  params_lib.tree_leaves(trainer.state_tree(b))):
    assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_tree_paths_follow_leaf_order():
  tree = {'b': {'y': 1, 'x': 2}, 'a': 3}
  assert params_lib.tree_paths(tree) == ['a', 'b.x', 'b.y']
  assert params_lib.tree_leaves(tree) == [3, 2, 1]
