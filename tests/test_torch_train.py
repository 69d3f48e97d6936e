"""The port's training slice against mt3_tpu: losses, Adafactor, train step.

The same numpy inputs (and, for the train step, the same parameters and
optimizer state, carried across with trainer.load_state_tree) go through
the JAX function and the port's.  Tolerances:

  * losses and metrics: rtol 1e-6 (float32 sums over 64-128 tokens);
  * Adafactor, 3 steps on factored, unfactored and stacked leaves:
    parameters and statistics within 1e-6 (atol, and rtol for the
    statistics, which span many decades);
  * train steps without and with num_microbatches=2: parameters within
    1e-6; Adafactor statistics within 1e-5 of each leaf's largest (they
    are squared gradients, whose small entries carry the float32 sum-order
    differences of the two backward passes at ~1e-2 relative); metrics
    rtol 1e-5.  The step differentiates the summed loss, as the JAX step
    does: normalising before backward() would move the update only through
    eps, below a looser tolerance, so parameters are held at 1e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.train import adafactor as jax_adafactor
from mt3_tpu.train import losses as jax_losses
from mt3_tpu.train import trainer as jax_trainer
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config
from mt3_tpu_torch.train import adafactor, checkpoint, losses, trainer

torch.set_num_threads(2)


@pytest.mark.parametrize('label_smoothing', (0.0, 0.1))
def test_losses_and_metrics_match_jax(label_smoothing):
  rng = np.random.RandomState(int(label_smoothing * 10))
  logits = (rng.randn(3, 24, 50) * 3).astype(np.float32)
  targets = rng.randint(0, 50, (3, 24)).astype(np.int32)
  weights = (rng.rand(3, 24) > 0.3).astype(np.float32)
  want = jax_losses.cross_entropy_with_z_loss(
      logits, targets, weights, label_smoothing=label_smoothing, z_loss=1e-4)
  got = losses.cross_entropy_with_z_loss(
      torch.from_numpy(logits), torch.from_numpy(targets),
      torch.from_numpy(weights), label_smoothing=label_smoothing,
      z_loss=1e-4)
  np.testing.assert_allclose([float(x) for x in got],
                             [float(x) for x in want], rtol=1e-6)
  want_m = jax_losses.compute_metrics(logits, targets, weights)
  got_m = losses.compute_metrics(torch.from_numpy(logits),
                                 torch.from_numpy(targets),
                                 torch.from_numpy(weights))
  assert set(got_m) == set(want_m)
  for key in want_m:
    np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                               rtol=1e-6)


def _adafactor_tree(rng):
  return {
      'dense': rng.randn(128, 256).astype(np.float32) * 0.05,  # factored
      'stacked': rng.randn(2, 128, 160).astype(np.float32),   # per layer
      'narrow': rng.randn(4, 200).astype(np.float32),        # unfactored
      'scale': np.ones(64, np.float32),                      # vector
  }


def test_adafactor_three_steps_match_jax():
  rng = np.random.RandomState(0)
  tree = _adafactor_tree(rng)
  grads = [jax.tree_util.tree_map(
      lambda p: rng.randn(*p.shape).astype(np.float32) * 0.1, tree)
      for _ in range(3)]
  jax_params, jax_state = tree, jax_adafactor.init(tree)
  params = params_lib.from_numpy_tree(tree)
  leaves = params_lib.tree_leaves(params)
  opt = adafactor.Adafactor(leaves)
  for i, g in enumerate(grads):
    lr = 1e-2 * (i + 1)
    jax_params, jax_state = jax_adafactor.apply_updates(
        jax_params, g, jax_state, np.float32(lr))
    for p, gl in zip(leaves, params_lib.tree_leaves(g)):
      p.grad = torch.from_numpy(gl)
    opt.param_groups[0]['lr'] = lr
    opt.step()
  assert int(jax_state.step) == 3
  assert {opt.state[p]['step'] for p in leaves} == {3}
  for p, w in zip(leaves, params_lib.tree_leaves(jax_params)):
    np.testing.assert_allclose(p.numpy(), np.asarray(w), atol=1e-6, rtol=0)
  for name in ('v_row', 'v_col', 'v_full'):
    for p, w in zip(leaves, params_lib.tree_leaves(getattr(jax_state, name))):
      np.testing.assert_allclose(opt.state[p][name].numpy(), np.asarray(w),
                                 atol=1e-6, rtol=1e-6)
  # Factoring: the stacked leaf keeps per-layer row and column statistics.
  stacked = params['stacked']
  assert opt.state[stacked]['v_row'].shape == (2, 128)
  assert opt.state[stacked]['v_col'].shape == (2, 160)
  assert opt.state[params['narrow']]['v_full'].shape == (4, 200)


def test_learning_rate_schedule_matches_jax():
  run = config.RunConfig(learning_rate=1e-3, warmup_steps=1000)
  jax_run = jax_config.RunConfig(learning_rate=1e-3, warmup_steps=1000)
  ours, theirs = (trainer.create_learning_rate_fn(run),
                  jax_trainer.create_learning_rate_fn(jax_run))
  for step in (0, 1, 17, 500, 999, 1000, 1001, 10**6):
    assert ours(step) == float(theirs(step)), step
  flat = trainer.create_learning_rate_fn(dataclasses.replace(
      run, warmup_steps=0))
  assert flat(0) == 0.0 and flat(1) == pytest.approx(1e-3)


def _tiny():
  jax_cfg = jax_config.tiny_config()
  run = dataclasses.replace(jax_cfg.run, warmup_steps=1,
                            label_smoothing=0.1)
  jax_cfg = dataclasses.replace(jax_cfg, run=run)
  port_cfg = config.tiny_config()
  port_cfg = dataclasses.replace(port_cfg, run=config.RunConfig(
      **dataclasses.asdict(run)))
  return jax_cfg, port_cfg


def _numpy_state(jax_state):
  return {'step': np.asarray(jax_state.step),
          'params': jax.tree_util.tree_map(np.asarray, jax_state.params),
          'opt_state': {
              name: jax.tree_util.tree_map(
                  np.asarray, getattr(jax_state.opt_state, name))
              for name in ('v_row', 'v_col', 'v_full')}}


@pytest.mark.parametrize('num_microbatches', (0, 2))
def test_train_steps_match_jax(num_microbatches):
  jax_cfg, port_cfg = _tiny()
  jax_state, _ = jax_trainer.init_train_state(jax.random.PRNGKey(0),
                                              jax_cfg.model)
  state = trainer.init_train_state(port_cfg.model, device='cpu')
  trainer.load_state_tree(state, _numpy_state(jax_state))
  rng = np.random.RandomState(1)
  model = jax_cfg.model
  for _ in range(2):   # learning rates 0 and 1e-3
    batch = jax_trainer.make_train_batch(
        rng, 4, jax_cfg.run.inputs_length, jax_cfg.run.targets_length,
        model.input_depth, model.vocab_size)
    batch['decoder_target_tokens'][:, -3:] = 0   # some padding
    batch['decoder_loss_weights'] = (
        batch['decoder_target_tokens'] > 0).astype(np.int32)
    jax_state, jax_metrics = jax_trainer.train_step(
        jax_state, batch, jax.random.PRNGKey(0), model, jax_cfg.run,
        num_microbatches=num_microbatches)
    state, metrics = trainer.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0,
        port_cfg.model, port_cfg.run, num_microbatches=num_microbatches)
    want = _numpy_state(jax_state)
    got = trainer.state_tree(state)
    assert got['step'] == int(want['step'])
    for g, w in zip(params_lib.tree_leaves(got['params']),
                    params_lib.tree_leaves(want['params'])):
      np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
    for name in ('v_row', 'v_col', 'v_full'):
      for g, w in zip(params_lib.tree_leaves(got['opt_state'][name]),
                      params_lib.tree_leaves(want['opt_state'][name])):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert set(metrics) == set(jax_metrics)
    for key, value in jax_metrics.items():
      np.testing.assert_allclose(float(metrics[key]), float(value),
                                 rtol=1e-5, err_msg=key)


def test_state_tree_round_trip():
  _, port_cfg = _tiny()
  a = trainer.init_train_state(port_cfg.model,
                               torch.Generator().manual_seed(1), 'cpu')
  b = trainer.init_train_state(port_cfg.model,
                               torch.Generator().manual_seed(2), 'cpu')
  trainer.load_state_tree(b, params_lib.tree_map(
      lambda t: t.numpy() if torch.is_tensor(t) else t, trainer.state_tree(a)))
  for x, y in zip(params_lib.tree_leaves(trainer.state_tree(a)),
                  params_lib.tree_leaves(trainer.state_tree(b))):
    assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
  bad = trainer.state_tree(a)
  bad['opt_state']['v_row'] = params_lib.tree_map(
      lambda t: torch.zeros(3), bad['opt_state']['v_row'])
  with pytest.raises(ValueError, match='v_row shape'):
    trainer.load_state_tree(b, bad)


def _batch(seed):
  _, port_cfg = _tiny()
  return trainer.make_train_batch(
      np.random.RandomState(seed), 2, port_cfg.run.inputs_length,
      port_cfg.run.targets_length, port_cfg.model.input_depth,
      port_cfg.model.vocab_size)


def test_trainer_save_restore_round_trip(tmp_path):
  _, port_cfg = _tiny()
  model = dataclasses.replace(port_cfg.model, dropout_rate=0.1)
  a = trainer.Trainer(model, port_cfg.run, seed=3, device='cpu')
  for seed in range(3):
    a.step(_batch(seed))
  path = a.save(str(tmp_path))
  assert path.endswith('checkpoint_3.pt')
  assert checkpoint.latest_checkpoint(str(tmp_path)) == path
  b = trainer.Trainer(model, port_cfg.run, seed=3, device='cpu')
  assert b.restore(str(tmp_path)) == 3
  for x, y in zip(params_lib.tree_leaves(trainer.state_tree(a.state)),
                  params_lib.tree_leaves(trainer.state_tree(b.state))):
    assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
  # The restored trainer continues exactly (dropout seeded by step).
  ma, mb = a.step(_batch(9)), b.step(_batch(9))
  assert float(ma['loss']) == float(mb['loss'])
  for x, y in zip(params_lib.tree_leaves(a.state.params),
                  params_lib.tree_leaves(b.state.params)):
    assert torch.equal(x, y)
  assert checkpoint.latest_checkpoint(str(tmp_path / 'missing')) is None
  with pytest.raises(FileNotFoundError):
    checkpoint.restore_checkpoint(str(tmp_path / 'nope.pt'), b.state)


def test_trainer_load_params_keeps_step_and_resets_optimizer():
  _, port_cfg = _tiny()
  tr = trainer.Trainer(port_cfg.model, port_cfg.run, device='cpu')
  tr.step(_batch(0))
  fresh = params_lib.init_params(port_cfg.model,
                                 torch.Generator().manual_seed(5))
  tr.load_params(params_lib.to_numpy_tree(fresh))
  assert tr.state.step == 1
  for p, w in zip(params_lib.tree_leaves(tr.state.params),
                  params_lib.tree_leaves(fresh)):
    assert torch.equal(p.detach(), w) and p.requires_grad
    assert tr.state.optimizer.state[p]['step'] == 0
  with pytest.raises(ValueError, match='shape mismatch'):
    tr.load_params(params_lib.tree_map(lambda t: t[..., :1], fresh))


def test_trainer_mesh_raises():
  _, port_cfg = _tiny()
  with pytest.raises(NotImplementedError, match='multi-device'):
    trainer.Trainer(port_cfg.model, port_cfg.run, mesh=object(),
                    device='cpu')


def test_cli_trains_and_resumes_on_cpu(tmp_path, capsys):
  from mt3_tpu_torch.cli import train as cli
  args = ['--model', 'tiny', '--batch_size', '2', '--device', 'cpu',
          '--checkpoint_dir', str(tmp_path), '--log_every', '1']
  cli.main(args + ['--steps', '2'])
  err = capsys.readouterr().err
  assert 'step 0: loss=' in err and 'step 1: loss=' in err
  assert (tmp_path / 'checkpoint_2.pt').exists()
  cli.main(args + ['--steps', '3', '--resume'])
  err = capsys.readouterr().err
  assert 'resumed from step 2' in err and 'step 2: loss=' in err
  assert 'step 1:' not in err
  assert (tmp_path / 'checkpoint_3.pt').exists()


@pytest.mark.parametrize('flag', (
    ['--eval_period', '2'], ['--init_from', 'x'],
    ['--init_from', 'x', '--gqa_kv_heads', '2'],
    ['--cache_dir', 'x'], ['--num_model_partitions', '2'],
    ['--log_dir', 'x'], ['--data', 'corpus.tfrecord']))
def test_cli_unported_flags_raise(flag):
  from mt3_tpu_torch.cli import train as cli
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    cli.main(['--model', 'tiny', '--steps', '1', '--device', 'cpu'] + flag)
