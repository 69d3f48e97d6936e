"""Serving on the port's ('data', 'model') mesh: four CPU processes over gloo.

The counterpart of tests/test_sharded_infer.py, on its tiny configuration
(emb 64, 2 heads x 32, input depth 512) and JAX's initial parameters.  The
four ranks of a (2, 2) mesh are spawned once (this file is its own
worker: `python tests/test_torch_sharded_infer.py worker RANK WORLD STORE
ARGS`, rendezvous through a file:// store in tmp_path); each runs
Transcriber(mesh=) on the same 2 s of noise and prints one JSON line:

  * params split by their logical axes: the same segment start times and
    notes as JAX's Transcriber (tests/test_sharded_infer.py:32-52) and the
    same tokens as the port on one device;
  * the production quantization configuration (int4 cache, int8 cross
    K/V), and the same with one K/V head, replicated over 'model', and the
    stacked carry: the same tokens as the port on one device;
  * num_beams=3: the same tokens as the port on one device;
  * params replicated (no params_axes, data parallelism only): the same
    tokens as the port on one device.

Every rank returns the whole result (the tokens are gathered over 'data').
"""

import dataclasses
import datetime
import json
import os
import subprocess
import sys
import uuid

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
NICE = 10          # the spawned processes' niceness
CASES = {
    'split': ({}, 0, True),
    'quantized': (dict(decode_kv_quantize=True, decode_kv_bits=4,
                       decode_cross_kv_quantize=True), 0, True),
    'production': (dict(num_kv_heads=1, decode_kv_quantize=True,
                        decode_kv_bits=4, decode_cross_kv_quantize=True,
                        decode_cache_carry='stacked'), 0, True),
    'beams': ({}, 3, True),
    'replicated': ({}, 0, False),
}


def _setup(config_module, vocabulary_module, **overrides):
  """tests/test_sharded_infer.py's tiny configuration."""
  vocab_config = config_module.VocabularyConfig(num_velocity_bins=1)
  codec = vocabulary_module.build_codec(vocab_config)
  vocab = vocabulary_module.vocabulary_from_codec(codec)
  model_config = config_module.ModelConfig(
      vocab_size=vocabulary_module.num_embeddings(vocab), emb_dim=64,
      num_heads=2, num_encoder_layers=2, num_decoder_layers=2, head_dim=32,
      mlp_dim=64, dropout_rate=0.0, input_depth=512, max_positions=256,
      **overrides)
  run_config = config_module.RunConfig(
      inputs_length=64, targets_length=32, batch_size=8, infer_batch_size=8,
      use_ties=True)
  return config_module.MT3Config('test', config_module.SpectrogramConfig(),
                                 vocab_config, model_config, run_config)


def _audio(sample_rate):
  return np.random.RandomState(0).randn(sample_rate * 2).astype(np.float32)


def _summary(transcriber, audio, postprocess):
  """Tokens of each segment, start times and notes of a transcription
  (Transcriber.transcribe's steps, the segments decoded once)."""
  predictions = transcriber.predict_segments(audio)
  result = postprocess.event_predictions_to_ns(
      predictions, transcriber.codec, transcriber.encoding_spec)
  notes = [(n.pitch, round(n.start_time, 3), n.program, n.is_drum)
           for n in result['est_ns'].sorted_notes()]
  return {'tokens': [np.asarray(p['est_tokens']).tolist()
                     for p in predictions],
          'start_times': list(result['start_times']), 'notes': notes}


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
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.codec import vocabulary
  from mt3_tpu_torch.core import config
  from mt3_tpu_torch.infer import postprocess, transcribe
  from mt3_tpu_torch.parallel import multihost, partitioning

  multihost.initialize(f'file://{store}', world, rank, backend='gloo',
                       timeout=datetime.timedelta(seconds=TIMEOUT - 20))
  mesh = partitioning.make_mesh(2, device='cpu')
  out = {'coords': [mesh.data_index, mesh.model_index]}
  for case, (overrides, beams, split) in CASES.items():
    cfg = _setup(config, vocabulary, **overrides)
    with np.load(args['mha' if 'num_kv_heads' not in overrides
                      else 'gqa']) as f:
      params = params_lib.from_numpy_tree(_unflatten(dict(f)))
    tr = transcribe.Transcriber(
        cfg, params, num_beams=beams, mesh=mesh,
        params_axes=params_lib.param_axes(cfg.model) if split else None)
    out[case] = _summary(tr, _audio(cfg.spectrogram.sample_rate),
                         postprocess)
  multihost.shutdown()
  print(json.dumps(out), flush=True)


if __name__ != '__main__':
  import jax
  import pytest

  from mt3_tpu.codec import vocabulary as jax_vocabulary
  from mt3_tpu.core import config as jax_config
  from mt3_tpu.infer import transcribe as jax_transcribe
  from mt3_tpu.models import t5 as jax_t5
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.codec import vocabulary
  from mt3_tpu_torch.core import config
  from mt3_tpu_torch.infer import postprocess, transcribe

  def _jax_params(num_kv_heads=None):
    cfg = _setup(jax_config, jax_vocabulary)
    model = dataclasses.replace(cfg.model, num_kv_heads=num_kv_heads)
    params, _ = jax_t5.init_params(jax.random.PRNGKey(0), model)
    return jax.tree_util.tree_map(np.asarray, params)

  @pytest.fixture(scope='module')
  def params():
    return {'mha': _jax_params(), 'gqa': _jax_params(num_kv_heads=1)}

  @pytest.fixture(scope='module')
  def ranks(params, tmp_path_factory):
    """The four ranks' summaries of every case."""
    tmp = tmp_path_factory.mktemp('serve')
    args = {}
    for name, tree in params.items():
      path = tmp / f'{name}.npz'
      np.savez(path, **dict(zip(params_lib.tree_paths(tree),
                                params_lib.tree_leaves(tree))))
      args[name] = str(path)
    env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    store = tmp / f'store-{uuid.uuid4().hex}'
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), 'worker', str(rank), '4',
         str(store), json.dumps(args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(4)]
    outs = []
    try:
      for p in procs:
        out, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, f'rank failed:\n{err[-4000:]}'
        outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
      for p in procs:
        if p.poll() is None:
          p.kill()
          p.communicate()
    return outs

  @pytest.fixture(scope='module')
  def single(params):
    """The port on one device, every case."""
    out = {}
    for case, (overrides, beams, _) in CASES.items():
      cfg = _setup(config, vocabulary, **overrides)
      tree = params['gqa' if 'num_kv_heads' in overrides else 'mha']
      tr = transcribe.Transcriber(cfg, params_lib.from_numpy_tree(tree),
                                  num_beams=beams, device='cpu')
      out[case] = json.loads(json.dumps(
          _summary(tr, _audio(cfg.spectrogram.sample_rate), postprocess)))
    return out

  def test_split_params_match_jax_transcriber(ranks, params):
    cfg = _setup(jax_config, jax_vocabulary)
    result = jax_transcribe.Transcriber(cfg, params['mha']).transcribe(
        _audio(cfg.spectrogram.sample_rate))
    notes = [(n.pitch, round(n.start_time, 3))
             for n in result['est_ns'].sorted_notes()]
    assert notes
    assert [r['coords'] for r in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    for r in ranks:
      assert r['split']['start_times'] == list(result['start_times'])
      assert [tuple(n[:2]) for n in r['split']['notes']] == notes

  @pytest.mark.parametrize('case', list(CASES))
  def test_mesh_tokens_match_one_device(ranks, single, case):
    for r in ranks:
      assert r[case] == single[case], case
    assert any(single[case]['tokens'])


if __name__ == '__main__' and sys.argv[1] == 'worker':
  _worker_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
               json.loads(sys.argv[5]))
