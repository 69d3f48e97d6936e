"""Parameter bridge and initialization of the PyTorch port vs mt3_tpu."""

import jax
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.models import t5

torch.set_num_threads(2)

FACTORIES = {'tiny': 'tiny_config', 'mt3': 'mt3_config'}


def _leaves(tree, prefix=()):
  if isinstance(tree, dict):
    out = {}
    for key in sorted(tree):
      out.update(_leaves(tree[key], prefix + (key,)))
    return out
  return {prefix: tree}


@pytest.fixture(scope='module', params=sorted(FACTORIES))
def width(request):
  name = request.param
  jax_cfg = getattr(jax_config, FACTORIES[name])().model
  torch_cfg = getattr(torch_config, FACTORIES[name])().model
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(0), jax_cfg)
  return name, jax_cfg, torch_cfg, jax.tree_util.tree_map(np.asarray,
                                                          jax_params)


def test_bridge_round_trip(width):
  _, _, _, numpy_params = width
  torch_params = params_lib.from_numpy_tree(numpy_params)
  src, mid = _leaves(numpy_params), _leaves(torch_params)
  assert list(src) == list(mid)
  for path, leaf in src.items():
    assert isinstance(mid[path], torch.Tensor)
    assert mid[path].dtype == torch.float32
    assert tuple(mid[path].shape) == leaf.shape, path
  back = _leaves(params_lib.to_numpy_tree(torch_params))
  assert list(back) == list(src)
  for path, leaf in src.items():
    np.testing.assert_array_equal(back[path], leaf, err_msg=str(path))


def test_init_params_structure_and_distributions(width):
  name, _, torch_cfg, numpy_params = width
  ours = _leaves(t5.init_params(torch_cfg, torch.Generator().manual_seed(0)))
  theirs = _leaves(numpy_params)
  assert list(ours) == list(theirs)
  for path, leaf in theirs.items():
    assert tuple(ours[path].shape) == leaf.shape, path
  if name != 'mt3':
    return
  # Same distributions as the JAX initializers (values differ).
  for path in (('decoder', 'layers', 'mlp', 'wi_0'),
               ('decoder', 'layers', 'self_attention', 'query'),
               ('decoder', 'token_embed'),
               ('encoder', 'input_proj')):
    ours_std = float(ours[path].std())
    theirs_std = float(theirs[path].std())
    assert abs(ours_std - theirs_std) < 0.02 * theirs_std, path
    bound = float(np.abs(theirs[path]).max())
    if path != ('decoder', 'token_embed'):  # truncated at 2 std
      assert float(ours[path].abs().max()) <= bound * 1.01, path
  assert torch.equal(ours[('encoder', 'norm')], torch.ones(512))


def test_init_params_reproducible():
  cfg = torch_config.tiny_config().model
  a = _leaves(t5.init_params(cfg, torch.Generator().manual_seed(3)))
  b = _leaves(t5.init_params(cfg, torch.Generator().manual_seed(3)))
  c = _leaves(t5.init_params(cfg, torch.Generator().manual_seed(4)))
  assert all(torch.equal(a[k], b[k]) for k in a)
  assert not torch.equal(a[('encoder', 'input_proj')],
                         c[('encoder', 'input_proj')])
