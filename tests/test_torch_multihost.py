"""Training on the port's ('data', 'model') mesh: several CPU processes over gloo.

The counterpart of tests/test_multihost.py.  Each mesh shape spawns its
processes once (this file is its own worker:
`python tests/test_torch_multihost.py worker RANK WORLD STORE ARGS`), which
rendezvous through a file:// store in tmp_path and print one JSON line;
spawned processes run at niceness 10, below the other test workers.
Every rank trains the same cases for 3 steps on its rows of one global
batch (tests/test_multihost.py:51-68's batch):

  * 'tiny': tests/test_multihost.py's configuration on JAX's initial
    parameters: losses within rtol 2e-4 of JAX's single-process trajectory
    and of the port's single-device one (different reduction orders);
  * 'factored': emb 128, mlp 256, 4 heads x 32, vocab 256, input depth 128,
    where Adafactor factors the split leaves: losses, grad_norm and
    param_norm within rtol 2e-4 of one device, and the state gathered from
    the shards (its checkpoint) equal to one device's: parameters within
    2e-5, statistics within 1e-3 of each leaf's largest (squared gradients
    in another summation order); on (2, 2) the checkpoint restored in a
    single-device Trainer;
  * 'gqa': one K/V head, replicated over 'model' (2 heads a model rank);
  * 'dropout': dropout 0.1 with remat: the masks are drawn at the global
    shape and sliced, so the losses equal one device's with the same seed
    (rtol 2e-4).

Data replicas hold bit-identical leaves after the steps, and so do the
model ranks for every replicated leaf.  The (2, 2) mesh is built as a
hybrid mesh of two simulated nodes (LOCAL_WORLD_SIZE=2): each model pair
lies inside one node.  Last, the train CLI at world size 2 with
--num_model_partitions 2 writes a checkpoint that one process restores,
equal to the single-process CLI's.
"""

import datetime
import hashlib
import json
import os
import subprocess
import sys
import uuid

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120     # seconds a spawned rank may take; a hang fails the test
NICE = 10          # the spawned processes' niceness
STEPS = 3
CASES = {
    'tiny': dict(vocab_size=128, emb_dim=32, num_heads=4,
                 num_encoder_layers=2, num_decoder_layers=2, head_dim=8,
                 mlp_dim=64, mlp_activations=('gelu', 'linear'),
                 dropout_rate=0.0, input_depth=16, max_positions=64),
    'factored': dict(vocab_size=256, emb_dim=128, num_heads=4,
                     num_encoder_layers=2, num_decoder_layers=2, head_dim=32,
                     mlp_dim=256, mlp_activations=('gelu', 'linear'),
                     dropout_rate=0.0, input_depth=128, max_positions=64),
}
CASES['gqa'] = dict(CASES['tiny'], num_kv_heads=1)
CASES['dropout'] = dict(CASES['tiny'], dropout_rate=0.1, remat=True)
SEEDS = {'tiny': 0, 'factored': 1, 'gqa': 2, 'dropout': 3}
RUN = dict(inputs_length=8, targets_length=16, batch_size=8, warmup_steps=2)


def _configs(config_module, case):
  return (config_module.ModelConfig(**CASES[case]),
          config_module.RunConfig(**RUN))


def _batch(trainer_module, model):
  return trainer_module.make_train_batch(
      np.random.RandomState(0), RUN['batch_size'], RUN['inputs_length'],
      RUN['targets_length'], model.input_depth, model.vocab_size)


# ---------------------------------------------------------------------------
# Worker side (no JAX)
# ---------------------------------------------------------------------------
def _train_worker(args, multihost):
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.core import config
  from mt3_tpu_torch.train import trainer

  mesh = multihost.make_multihost_mesh(
      args['model'], dcn_data_parallelism=args.get('dcn'), device='cpu')
  out = {'mesh': [mesh.data, mesh.model],
         'coords': [mesh.data_index, mesh.model_index], 'cases': {}}
  for case in args['cases']:
    model, run = _configs(config, case)
    tr = trainer.Trainer(model, run, mesh=mesh, seed=SEEDS[case])
    if case == 'tiny':
      with np.load(args['tiny_params']) as f:
        flat = dict(f)
      tr.load_params(_unflatten(flat))
    batch = _batch(trainer, model)
    record = {'loss': [], 'grad_norm': [], 'param_norm': []}
    for _ in range(STEPS):
      metrics = tr.step(tr.shard_batch(batch))
      for key in record:
        record[key].append(float(metrics[key]))
    paths = params_lib.tree_paths(tr.state.params)
    record['dims'] = dict(zip(paths, params_lib.tree_leaves(tr.state.dims)))
    record['hashes'] = {
        path: hashlib.sha1(leaf.detach().numpy().tobytes()).hexdigest()
        for path, leaf in zip(paths, params_lib.tree_leaves(tr.state.params))}
    if case == args.get('save'):
      record['checkpoint'] = tr.save(args['checkpoint_dir'])
    out['cases'][case] = record
  return out


def _unflatten(flat):
  tree = {}
  for path, value in flat.items():
    node = tree
    *parents, leaf = path.split('.')
    for key in parents:
      node = node.setdefault(key, {})
    node[leaf] = value
  return tree


def _worker_main(rank, world, store, args):
  # Below the test workers' priority, so that the ranks, more processes
  # than a test usually runs, take the host's idle cores first.
  os.nice(NICE)
  import torch
  torch.set_num_threads(1)
  sys.path.insert(0, ROOT)
  from mt3_tpu_torch.parallel import multihost
  os.environ['LOCAL_WORLD_SIZE'] = str(args.get('node_size', world))
  multihost.initialize(f'file://{store}', world, rank, backend='gloo',
                       timeout=datetime.timedelta(seconds=TIMEOUT - 20))
  result = _train_worker(args, multihost)
  multihost.shutdown()
  print(json.dumps(result), flush=True)


# ---------------------------------------------------------------------------
# Test side
# ---------------------------------------------------------------------------
def _communicate(procs):
  outs = []
  try:
    for p in procs:
      out, err = p.communicate(timeout=TIMEOUT)
      assert p.returncode == 0, f'rank failed:\n{err[-4000:]}\n{out[-2000:]}'
      outs.append(out)
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.communicate()
  return outs


def _env(**extra):
  env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
  env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS='1', **extra)
  return env


def _spawn(tmp_path, world, args):
  """Run one job's ranks; returns their results.  One job at a time, so
  that no more processes than the largest mesh's share the host's cores
  with the other test workers."""
  store = tmp_path / f'store-{uuid.uuid4().hex}'
  procs = [subprocess.Popen(
      [sys.executable, os.path.abspath(__file__), 'worker', str(rank),
       str(world), str(store), json.dumps(args)],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
      env=_env()) for rank in range(world)]
  return [json.loads(out.strip().splitlines()[-1])
          for out in _communicate(procs)]


if __name__ != '__main__':
  import jax
  import pytest
  import torch

  from mt3_tpu.core import config as jax_config
  from mt3_tpu.train import trainer as jax_trainer
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.core import config
  from mt3_tpu_torch.train import trainer

  MESHES = {'2x2': (2, 2), '1x2': (1, 2), '2x1': (2, 1)}

  @pytest.fixture(scope='module')
  def jax_tiny(tmp_path_factory):
    """JAX's single-process trajectory on 'tiny' and its initial params."""
    model, run = _configs(jax_config, 'tiny')
    tr = jax_trainer.Trainer(model_config=model, run_config=run, seed=0)
    params = jax.tree_util.tree_map(np.asarray, tr.state.params)
    batch = _batch(jax_trainer, model)
    losses = [float(tr.step(batch)['loss']) for _ in range(STEPS)]
    path = tmp_path_factory.mktemp('jax') / 'tiny.npz'
    paths = params_lib.tree_paths(params)
    np.savez(path, **dict(zip(paths, params_lib.tree_leaves(params))))
    return {'losses': losses, 'params': params, 'path': str(path)}

  @pytest.fixture(scope='module')
  def single(jax_tiny):
    """The port's single-device runs of every case: metrics and trainer."""
    out = {}
    for case in CASES:
      model, run = _configs(config, case)
      tr = trainer.Trainer(model, run, seed=SEEDS[case], device='cpu')
      if case == 'tiny':
        tr.load_params(params_lib.from_numpy_tree(jax_tiny['params']))
      batch = _batch(trainer, model)
      record = {'loss': [], 'grad_norm': [], 'param_norm': []}
      for _ in range(STEPS):
        metrics = tr.step(batch)
        for key in record:
          record[key].append(float(metrics[key]))
      out[case] = dict(record, trainer=tr)
    return out

  @pytest.fixture(scope='module')
  def runs(jax_tiny, tmp_path_factory):
    """Each mesh's ranks, spawned once on first use."""
    cache = {}

    def get(name):
      if name not in cache:
        data, model = MESHES[name]
        tmp = tmp_path_factory.mktemp(f'mesh{name}')
        args = {'model': model, 'tiny_params': jax_tiny['path'],
                'cases': list(CASES), 'checkpoint_dir': str(tmp / 'ckpt'),
                'save': 'factored'}
        if name == '2x2':   # two simulated nodes of two processes
          args.update(dcn=2, node_size=2)
        cache[name] = _spawn(tmp, data * model, args)
      return cache[name]
    return get

  @pytest.mark.parametrize('mesh', list(MESHES))
  def test_losses_match_jax_and_single_device(runs, jax_tiny, single, mesh):
    results = runs(mesh)
    assert all(r['mesh'] == list(MESHES[mesh]) for r in results)
    for r in results:
      losses = r['cases']['tiny']['loss']
      np.testing.assert_allclose(losses, jax_tiny['losses'], rtol=2e-4)
      np.testing.assert_allclose(losses, single['tiny']['loss'], rtol=2e-4)
    assert results[0]['cases']['tiny']['loss'][-1] < (
        results[0]['cases']['tiny']['loss'][0])

  @pytest.mark.parametrize('mesh', list(MESHES))
  def test_replicated_leaves_bit_identical_across_ranks(runs, mesh):
    results = runs(mesh)
    for case in CASES:
      for a in results:
        for b in results:
          ra, rb = a['cases'][case], b['cases'][case]
          if a['coords'][1] == b['coords'][1]:       # data replicas
            assert ra['hashes'] == rb['hashes'], (case, a['coords'],
                                                  b['coords'])
          for path, dim in ra['dims'].items():     # replicated over 'model'
            if dim is None:
              assert ra['hashes'][path] == rb['hashes'][path], (case, path)

  def _hold_state(got, trainer_):
    """A gathered state tree against a single-device trainer's."""
    want = trainer.state_tree(trainer_.state)
    assert int(got['step']) == want['step']
    for g, w in zip(params_lib.tree_leaves(got['params']),
                    params_lib.tree_leaves(want['params'])):
      np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5)
    for name in ('v_row', 'v_col', 'v_full'):
      for g, w in zip(params_lib.tree_leaves(got['opt_state'][name]),
                      params_lib.tree_leaves(want['opt_state'][name])):
        assert g.shape == w.shape, name
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-3 * scale, name

  @pytest.mark.parametrize('mesh', list(MESHES))
  def test_factored_adafactor_on_shards(runs, single, mesh):
    """The metrics, and the whole state gathered from the shards (the
    checkpoint's tree), against one device's."""
    record = runs(mesh)[0]['cases']['factored']
    if MESHES[mesh][1] > 1:   # factored leaves are split over 'model'
      assert record['dims']['decoder.layers.mlp.wo'] == -2
      assert record['dims']['decoder.layers.mlp.wi_0'] == -1
    # Some leaves are factored: their v_full is a (1,) placeholder.
    leaves = single['factored']['trainer'].state.optimizer.state
    assert any(s['v_full'].numel() == 1 for s in leaves.values())
    for key in ('loss', 'grad_norm', 'param_norm'):
      np.testing.assert_allclose(record[key], single['factored'][key],
                                 rtol=2e-4, err_msg=key)
    _hold_state(torch.load(record['checkpoint'], weights_only=True),
                single['factored']['trainer'])

  @pytest.mark.parametrize('mesh', list(MESHES))
  def test_one_kv_head_replicated_over_model(runs, single, mesh):
    record = runs(mesh)[0]['cases']['gqa']
    if MESHES[mesh][1] > 1:
      for name in ('key', 'value'):
        assert record['dims'][f'decoder.layers.self_attention.{name}'] is None
      assert record['dims']['decoder.layers.self_attention.query'] == -1
    np.testing.assert_allclose(record['loss'], single['gqa']['loss'],
                               rtol=2e-4)

  @pytest.mark.parametrize('mesh', list(MESHES))
  def test_dropout_and_remat_match_single_device(runs, single, mesh):
    for r in runs(mesh):
      np.testing.assert_allclose(r['cases']['dropout']['loss'],
                                 single['dropout']['loss'], rtol=2e-4)
    # Dropout is live: the loss differs from the same model without it.
    assert single['dropout']['loss'][0] != single['tiny']['loss'][0]

  def test_mesh_checkpoint_restores_in_single_device_trainer(runs, single):
    path = runs('2x2')[0]['cases']['factored']['checkpoint']
    model, run = _configs(config, 'factored')
    restored = trainer.Trainer(model, run, seed=99, device='cpu')
    assert restored.restore(path) == STEPS
    _hold_state(trainer.state_tree(restored.state),
                single['factored']['trainer'])

  def test_hybrid_mesh_keeps_model_pairs_in_a_node(runs):
    results = runs('2x2')
    for rank, r in enumerate(results):
      data_index, model_index = r['coords']
      assert rank == data_index * 2 + model_index
      # A model group {2d, 2d + 1} lies in node d: ranks // node size 2.
      assert rank // 2 == data_index

  def test_cli_two_ranks_two_model_partitions(tmp_path):
    """torchrun's environment for 2 ranks; --num_model_partitions 2; the
    checkpoint equals the single-process CLI's (model partitions only, so
    both see the same batches)."""
    common = [os.path.abspath(__file__), 'cli', '--model', 'tiny',
              '--steps', '2', '--batch_size', '2', '--device', 'cpu',
              '--log_every', '1']
    store = tmp_path / 'store'
    procs = [subprocess.Popen(
        [sys.executable, *common, '--num_model_partitions', '2',
         '--coordinator_address', f'file://{store}',
         '--checkpoint_dir', str(tmp_path / 'mesh')],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(WORLD_SIZE='2', RANK=str(rank), LOCAL_RANK=str(rank)))
        for rank in range(2)]
    _communicate(procs)
    _communicate([subprocess.Popen(
        [sys.executable, *common, '--checkpoint_dir', str(tmp_path / 'one')],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env())])
    port_cfg = config.tiny_config()
    got = trainer.Trainer(port_cfg.model, port_cfg.run, device='cpu')
    want = trainer.Trainer(port_cfg.model, port_cfg.run, device='cpu')
    assert got.restore(str(tmp_path / 'mesh')) == 2
    assert want.restore(str(tmp_path / 'one')) == 2
    for g, w in zip(params_lib.tree_leaves(got.state.params),
                    params_lib.tree_leaves(want.state.params)):
      np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                 atol=2e-5)


if __name__ == '__main__' and sys.argv[1] == 'worker':
  _worker_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
               json.loads(sys.argv[5]))
elif __name__ == '__main__' and sys.argv[1] == 'cli':
  # `python -m mt3_tpu_torch.cli.train ARGS` at the workers' niceness.
  os.nice(NICE)
  import runpy
  sys.argv = ['mt3_tpu_torch.cli.train'] + sys.argv[2:]
  runpy.run_module('mt3_tpu_torch.cli.train', run_name='__main__')
