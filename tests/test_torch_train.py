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
import json

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
from mt3_tpu_torch.utils import events

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


@pytest.mark.parametrize('flag', (['--num_model_partitions', '2'],))
def test_cli_unported_flags_raise(flag):
  from mt3_tpu_torch.cli import train as cli
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    cli.main(['--model', 'tiny', '--steps', '1', '--device', 'cpu'] + flag)


# ---------------------------------------------------------------------------
# Asynchronous saves
# ---------------------------------------------------------------------------
def test_async_save_holds_the_state_of_its_step(tmp_path):
  """The optimizer updates parameters and statistics in place, so the
  snapshot is taken before save() returns: the step that follows at once
  does not reach the file."""
  _, port_cfg = _tiny()
  tr = trainer.Trainer(port_cfg.model, port_cfg.run, seed=1, device='cpu')
  tr.step(_batch(0))
  tr.step(_batch(1))
  at_save = params_lib.tree_map(
      lambda t: t.clone() if torch.is_tensor(t) else t,
      trainer.state_tree(tr.state))
  path = tr.save(str(tmp_path), asynchronous=True)
  tr.step(_batch(2))
  tr.finalize_saves()
  assert path.endswith('checkpoint_2.pt')
  saved = torch.load(path, map_location='cpu', weights_only=True)
  assert saved['step'] == 2
  moved = 0
  for x, y, now in zip(params_lib.tree_leaves(saved),
                       params_lib.tree_leaves(at_save),
                       params_lib.tree_leaves(trainer.state_tree(tr.state))):
    assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    moved += not torch.equal(torch.as_tensor(x), torch.as_tensor(now))
  assert moved > 0
  restored = trainer.Trainer(port_cfg.model, port_cfg.run, device='cpu')
  checkpoint.restore_checkpoint(path, restored.state)
  assert restored.state.step == 2


def test_async_saves_are_serialized_and_errors_surface(tmp_path, monkeypatch):
  _, port_cfg = _tiny()
  tr = trainer.Trainer(port_cfg.model, port_cfg.run, device='cpu')
  tr.finalize_saves()   # nothing pending
  paths = []
  for i in range(3):
    tr.step(_batch(i))
    paths.append(tr.save(str(tmp_path), asynchronous=True))
  tr.finalize_saves()
  assert [p.rsplit('_', 1)[1] for p in paths] == ['1.pt', '2.pt', '3.pt']
  assert checkpoint.latest_checkpoint(str(tmp_path)) == paths[-1]
  assert not list(tmp_path.glob('*.tmp'))

  def fail(tree, path):
    raise OSError('disk full')

  monkeypatch.setattr(checkpoint.torch, 'save', fail)
  tr.save(str(tmp_path / 'full'), asynchronous=True)
  with pytest.raises(OSError, match='disk full'):
    tr.finalize_saves()
  tr.finalize_saves()   # the error is raised once


# ---------------------------------------------------------------------------
# The CLI on the JAX package's flagship recipe (tiny preset, on the CPU)
# ---------------------------------------------------------------------------
def _write_validation_pairs(directory, count=2, seed=9_001_000):
  import wave
  from mt3_tpu_torch.core import midi_io
  from mt3_tpu_torch.data import synth
  directory.mkdir()
  for i in range(count):
    ns = synth.compose_example(seed + i, 2.0, max_instruments=2)
    audio = synth.render_note_sequence(ns, 2.0, seed=seed + i)
    with wave.open(str(directory / f'clip-{i:04d}.wav'), 'wb') as w:
      w.setnchannels(1)
      w.setsampwidth(2)
      w.setframerate(16000)
      w.writeframes((np.clip(audio, -1, 1) * 32767).astype('<i2').tobytes())
    midi_io.note_sequence_to_midi_file(ns, str(directory /
                                               f'clip-{i:04d}.mid'))


def test_staged_batches_stop_and_drain():
  import itertools
  import threading
  import time
  _, port_cfg = _tiny()
  hop = port_cfg.spectrogram.hop_width
  rng = np.random.RandomState(0)

  def raw():
    for i in itertools.count():
      yield {'encoder_input_frames': rng.randn(2, 4, hop).astype(np.float32),
             'decoder_target_tokens': np.full((2, 3), i, np.int32),
             'decoder_input_tokens': np.zeros((2, 3), np.int32),
             'decoder_loss_weights': np.ones((2, 3), np.float32)}

  threads = threading.active_count()
  staged = trainer.StagedBatches(raw(), port_cfg.spectrogram, 'cpu')
  got = [next(staged) for _ in range(3)]
  assert threading.active_count() == threads + 1
  staged.close()
  # The producer exits right after it queues its end marker.
  for _ in range(500):
    if threading.active_count() == threads:
      break
    time.sleep(0.01)
  assert threading.active_count() == threads
  assert [int(b['decoder_target_tokens'][0, 0]) for b in got] == [0, 1, 2]
  assert got[0]['encoder_input_tokens'].shape == (
      2, 4, port_cfg.spectrogram.num_mel_bins)
  # The queue holds 2 and the producer stages one more before it sees the
  # stop; nothing is staged after close().
  assert 3 <= staged.staged <= 6
  assert list(staged) == []


def test_cli_flagship_recipe_then_resume_from_shards(tmp_path, capsys):
  import threading
  from mt3_tpu_torch.cli import train as cli
  _write_validation_pairs(tmp_path / 'validation')
  common = ['--model', 'tiny', '--data', 'polysynth:4:1000',
            '--cache_dir', str(tmp_path / 'cache'),
            '--eval_data', str(tmp_path / 'validation'),
            '--eval_examples', '2', '--eval_period', '3',
            '--batch_size', '4', '--remat', '--attention', 'flash',
            '--bf16', '--checkpoint_dir', str(tmp_path / 'ckpt'),
            '--checkpoint_period', '2', '--log_dir', str(tmp_path / 'logs'),
            '--log_every', '1', '--device', 'cpu']
  threads = threading.active_count()
  cli.main(common + ['--steps', '3', '--preload_cache'])
  err = capsys.readouterr().err
  assert 'TFRecord reader: native (libmt3_native-' in err
  assert 'built segment cache: 4 segments' in err
  assert 'step 2: loss=' in err and 'eval@3: onset F1 = ' in err
  assert 'data: ' in err and 'batches staged for 3 steps' in err
  assert threading.active_count() == threads   # prefetch and writer ended
  # checkpoint_2 written on the writer thread; checkpoint_3 at the end.
  assert sorted(p.name for p in (tmp_path / 'ckpt').iterdir()) == [
      'checkpoint_2.pt', 'checkpoint_3.pt']
  _, port_cfg = _tiny()
  state = trainer.init_train_state(port_cfg.model, device='cpu')
  checkpoint.restore_checkpoint(str(tmp_path / 'ckpt' / 'checkpoint_2.pt'),
                                state)
  assert state.step == 2
  records = [json.loads(line) for line in
             (tmp_path / 'logs' / 'metrics.jsonl').read_text().splitlines()]
  assert [r['step'] for r in records] == [3] and 'Onset F1' in records[0]

  cli.main(common + ['--steps', '5', '--resume'])
  err = capsys.readouterr().err
  assert 'built segment cache' not in err and 'resumed from step 3' in err
  assert 'step 3: loss=' in err and 'step 4: loss=' in err
  assert 'step 2:' not in err
  assert (tmp_path / 'ckpt' / 'checkpoint_4.pt').exists()
  assert (tmp_path / 'ckpt' / 'checkpoint_5.pt').exists()
  # Two event files (one a run); together they hold every train step and
  # the one evaluation.
  tags = [event for path in (tmp_path / 'logs').glob('events.out.tfevents.*')
          for event in events.scalar_events(path)]
  assert sorted({s for t, s in tags if t == 'train/loss'}) == [0, 1, 2, 3, 4]
  assert {s for t, s in tags if t == 'eval/Onset F1'} == {3}
  assert ('train/learning_rate', 0) in tags


def test_cli_exit_rss_checkpoints_and_exits_75(tmp_path, capsys):
  import threading
  from mt3_tpu_torch.cli import train as cli
  threads = threading.active_count()
  with pytest.raises(SystemExit) as exit_info:
    cli.main(['--model', 'tiny', '--steps', '5', '--batch_size', '2',
              '--device', 'cpu', '--checkpoint_dir', str(tmp_path),
              '--checkpoint_period', '1', '--exit_rss_gb', '0.001'])
  assert exit_info.value.code == 75
  err = capsys.readouterr().err
  assert '--exit_rss_gb 0.001; checkpointing and exiting 75' in err
  assert 'saved restart checkpoint' in err
  assert sorted(p.name for p in tmp_path.iterdir()) == ['checkpoint_1.pt']
  assert threading.active_count() == threads


def test_cli_trains_on_a_slakh_tfrecord(tmp_path, capsys):
  from mt3_tpu_torch.cli import train as cli
  from mt3_tpu_torch.core import noteseq_proto
  from mt3_tpu_torch.core.note_sequence import Note, NoteSequence
  from mt3_tpu_torch.data import tfrecord

  def proto(pitch):
    ns = NoteSequence(total_time=1.0)
    ns.notes = [Note(pitch=pitch, velocity=90, start_time=0.1, end_time=0.7)]
    return noteseq_proto.notesequence_to_bytes(ns)

  path = str(tmp_path / 'slakh.tfrecord')
  tfrecord.write_records(path, [tfrecord.make_example({
      'mix': (np.random.RandomState(i).randn(24000) * 0.1).astype(np.float32),
      'audio_sample_rate': np.array([16000], np.int64),
      'note_sequences': [proto(60 + i), proto(38)],
      'inst_names': [b'Acoustic Piano', b'Drums'],
      'track_id': f'Track{i:05d}'.encode()}) for i in range(2)])
  cli.main(['--model', 'tiny', '--data', path, '--dataset', 'slakh',
            '--steps', '2', '--batch_size', '2', '--device', 'cpu',
            '--log_every', '1'])
  err = capsys.readouterr().err
  assert 'TFRecord reader: native' in err and 'dataset: 2 examples' in err
  assert 'step 1: loss=' in err
