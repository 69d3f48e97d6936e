"""The port's teacher-forced model and its gradients against mt3_tpu.

t5.forward (both train_attention_impl values) and the gradient of the
summed training loss with respect to every parameter leaf are compared
with the JAX package on the same parameters and batch: tiny dims with
max_positions 256 and lengths 128, so that the flash route engages (the
JAX side runs the stock kernel in interpret mode, the port its plain
version).  Targets are padded (100 and 60 of 128 tokens), as in
tests/test_model.py.

Tolerances: logits atol = rtol = 2e-4 at valid (non-padding) positions,
as tests/test_model.py holds flash against einsum; gradients per leaf
within 1e-4 * (max |g| of the leaf) + 1e-6 (float32 sums over the batch
in two sum orders; observed ~1e-6 relative).

The dropout and remat tests hold the port against itself: the flash route
with dropout equals the einsum route for one generator state, and
rematerialised layers give the gradients of the plain ones with dropout
live.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.experimental.pallas.tpu as pltpu
from mt3_tpu.core import config as jax_config
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu.train import losses as jax_losses
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config
from mt3_tpu_torch.models import layers, t5
from mt3_tpu_torch.train import losses

torch.set_num_threads(2)

LENGTH = 128
IMPLS = ('xla', 'flash')


def _jax_config(impl, dropout=0.0):
  return dataclasses.replace(jax_config.tiny_config().model,
                             max_positions=256, train_attention_impl=impl,
                             dropout_rate=dropout)


def _config(impl, dropout=0.0, **overrides):
  model = config.ModelConfig(**dataclasses.asdict(_jax_config(impl, dropout)))
  return dataclasses.replace(model, **overrides)


@pytest.fixture(scope='module')
def batch():
  rng = np.random.RandomState(0)
  model = _jax_config('xla')
  tgt = np.zeros((2, LENGTH), np.int32)
  tgt[0, :100] = rng.randint(3, model.vocab_size, 100)
  tgt[1, :60] = rng.randint(3, model.vocab_size, 60)
  inp = np.zeros_like(tgt)
  inp[:, 1:] = tgt[:, :-1]
  return {
      'encoder_input_tokens': rng.randn(2, LENGTH, model.input_depth).astype(
          np.float32),
      'decoder_input_tokens': inp,
      'decoder_target_tokens': tgt,
      'decoder_loss_weights': (tgt > 0).astype(np.float32),
  }


@pytest.fixture(scope='module')
def jax_params():
  params, _ = jax_t5.init_params(jax.random.PRNGKey(0), _jax_config('xla'))
  return jax.tree_util.tree_map(np.asarray, params)


def _jax_loss(params, model, batch):
  logits = jax_t5.forward(params, model, batch['encoder_input_tokens'],
                          batch['decoder_input_tokens'],
                          batch['decoder_target_tokens'])
  total, _, _ = jax_losses.cross_entropy_with_z_loss(
      logits, batch['decoder_target_tokens'], batch['decoder_loss_weights'],
      z_loss=1e-4)
  return total, logits


@pytest.fixture(scope='module')
def jax_results(jax_params, batch):
  """impl -> (logits, gradient leaves in sorted-key order)."""
  out = {}
  for impl in IMPLS:
    with pltpu.force_tpu_interpret_mode():
      (_, logits), grads = jax.value_and_grad(_jax_loss, has_aux=True)(
          jax_params, _jax_config(impl), batch)
    out[impl] = (np.asarray(logits), [
        np.asarray(g) for g in params_lib.tree_leaves(
            jax.tree_util.tree_map(np.asarray, grads))])
  return out


def _torch_batch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_loss_and_grads(params_np, model, batch, generator=None):
  params = params_lib.tree_map(lambda t: t.requires_grad_(),
                               params_lib.from_numpy_tree(params_np))
  b = _torch_batch(batch)
  logits = t5.forward(params, model, b['encoder_input_tokens'],
                      b['decoder_input_tokens'], b['decoder_target_tokens'],
                      generator=generator)
  total, _, _ = losses.cross_entropy_with_z_loss(
      logits, b['decoder_target_tokens'], b['decoder_loss_weights'],
      z_loss=1e-4)
  total.backward()
  return logits.detach().numpy(), [
      p.grad.numpy() for p in params_lib.tree_leaves(params)]


@pytest.mark.parametrize('impl', IMPLS)
def test_forward_logits_match_jax(impl, jax_params, jax_results, batch):
  logits, _ = _port_loss_and_grads(jax_params, _config(impl), batch)
  want, _ = jax_results[impl]
  valid = batch['decoder_target_tokens'] > 0
  np.testing.assert_allclose(logits[valid], want[valid], atol=2e-4, rtol=2e-4)
  assert np.isfinite(logits).all()


@pytest.mark.parametrize('impl', IMPLS)
def test_every_gradient_matches_jax_grad(impl, jax_params, jax_results,
                                         batch):
  _, grads = _port_loss_and_grads(jax_params, _config(impl), batch)
  _, want = jax_results[impl]
  assert len(grads) == len(want) == len(params_lib.tree_leaves(jax_params))
  for g, w in zip(grads, want):
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=1e-4 * np.abs(w).max() + 1e-6)


def test_flash_dropout_equals_einsum_dropout(jax_params, batch):
  """Same generator state -> same [b, h, 1, k] masks on both routes."""
  outs = {}
  for impl in IMPLS:
    outs[impl] = _port_loss_and_grads(
        jax_params, _config(impl, dropout=0.1), batch,
        generator=torch.Generator().manual_seed(7))
  no_dropout, _ = _port_loss_and_grads(jax_params, _config('xla'), batch)
  valid = batch['decoder_target_tokens'] > 0
  assert np.abs(outs['xla'][0] - no_dropout).max() > 1e-3  # dropout fired
  np.testing.assert_allclose(outs['flash'][0][valid], outs['xla'][0][valid],
                             atol=2e-4, rtol=2e-4)
  for g, w in zip(outs['flash'][1], outs['xla'][1]):
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=1e-4 * np.abs(w).max() + 1e-6)


@pytest.mark.parametrize('policy', ('full', 'dots'))
def test_remat_gradients_equal_plain_with_dropout(policy, jax_params, batch):
  """Recomputed layers rebuild their generators from the same seeds, so
  they draw the masks of the first pass: gradients agree to float32
  rounding (5e-6 relative to each leaf's largest entry)."""
  plain = _port_loss_and_grads(jax_params, _config('flash', dropout=0.1),
                               batch, torch.Generator().manual_seed(3))
  remat = _port_loss_and_grads(
      jax_params, _config('flash', dropout=0.1, remat=True,
                          remat_policy=policy),
      batch, torch.Generator().manual_seed(3))
  np.testing.assert_allclose(remat[0], plain[0], atol=1e-6, rtol=0)
  for g, w in zip(remat[1], plain[1]):
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=5e-6 * np.abs(w).max() + 1e-9)


def test_dropout_keep_rate_in_distribution():
  """Keep fractions of 200k draws within 5 standard deviations of 1 - rate,
  and kept values scaled by 1 / (1 - rate)."""
  rate, n = 0.1, 200_000
  gen = torch.Generator().manual_seed(0)
  keep = layers.dropout_keep(gen, (n,), rate, 'cpu').float()
  sd = np.sqrt(rate * (1 - rate) / n)
  assert abs(float(keep.mean()) - (1 - rate)) < 5 * sd
  x = torch.ones(4, 50_000, 8)
  y = t5._dropout(gen, x, rate)
  # Broadcast along length: one draw per (batch, feature) column.
  assert torch.equal(y, y[:, :1, :].expand_as(y))
  kept = y[:, 0, :] != 0
  assert torch.allclose(y[:, 0, :][kept], torch.tensor(1 / 0.9))
  y = t5._dropout(gen, torch.ones(2, 100_000), rate, broadcast_length=False)
  sd = np.sqrt(rate * (1 - rate) / y.numel())
  assert abs(float((y != 0).float().mean()) - (1 - rate)) < 5 * sd
  assert t5._dropout(None, x, rate) is x


def test_forward_without_generator_is_deterministic(jax_params, batch):
  model = _config('xla', dropout=0.1)
  a, _ = _port_loss_and_grads(jax_params, model, batch)
  b, _ = _port_loss_and_grads(jax_params, model, batch)
  np.testing.assert_array_equal(a, b)
  c, _ = _port_loss_and_grads(jax_params, model, batch,
                              torch.Generator().manual_seed(1))
  assert np.abs(a - c).max() > 1e-3
