"""Checkpoint import in the PyTorch port against mt3_tpu's readers.

* orbax: the JAX package's save_checkpoint writes a tiny train state; the
  port's restore_params equals JAX's restore_checkpoint(path, {'params':
  template}) leaf for leaf, exactly, float32 and bfloat16 leaves alike.
* T5X: a fixture written as tests/test_t5x_loader.py writes one, with gzip
  zarr chunks, plus flax's msgpack_serialize for the `checkpoint` file:
  float32, bf16, inline-ndarray and chunked leaves under an optimizer/
  target wrapper.  The port's flat dict and tree equal JAX's
  load_t5x_checkpoint / load_t5x_params exactly; a whole tiny model
  written so gives the port JAX's teacher-forced logits within 1e-5.
* The port's msgpack decoder and zarr reader (numpy and the standard
  library only) against flax's msgpack_restore and tensorstore.
* latest_checkpoint over a directory of both formats; the ImportError
  that names tensorstore where it is missing; load_transcriber and the
  train CLI's --init_from on the CPU.
"""

import inspect
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
from flax import serialization

import mt3_tpu_torch
from mt3_tpu.core import config as jax_config
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu.train import checkpoint as jax_ckpt
from mt3_tpu.train import t5x_loader as jax_t5x
from mt3_tpu.train import trainer as jax_trainer
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.models import t5
from mt3_tpu_torch.train import checkpoint as ckpt
from mt3_tpu_torch.train import t5x_loader
from mt3_tpu_torch.train import trainer

torch.set_num_threads(2)


def _leaves_equal(ours, theirs):
  """Port tree (torch) against a JAX tree: same paths, equal float32."""
  theirs = jax.tree_util.tree_map(np.asarray, theirs)
  params_lib.check_structure(ours, theirs)
  for a, b in zip(params_lib.tree_leaves(ours),
                  params_lib.tree_leaves(theirs)):
    assert a.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), b.astype(np.float32))


# ---------------------------------------------------------------------------
# orbax
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def jax_state():
  state, _ = jax_trainer.init_train_state(jax.random.PRNGKey(0),
                                          jax_config.tiny_config().model)
  return state


@pytest.mark.parametrize('dtype', ('float32', 'bfloat16'))
def test_orbax_params_equal_jax_restore(tmp_path, jax_state, dtype):
  state = jax_state._asdict()
  if dtype == 'bfloat16':
    state['params'] = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16), state['params'])
  path = jax_ckpt.save_checkpoint(str(tmp_path), 7, state)
  template = jax_t5.init_params(jax.random.PRNGKey(1),
                                jax_config.tiny_config().model)[0]
  want = jax_ckpt.restore_checkpoint(path, {'params': template})['params']
  got = ckpt.restore_params(
      path, params_lib.init_params(torch_config.tiny_config().model))
  _leaves_equal(got, want)


def test_orbax_restore_checks_structure_and_shapes(tmp_path, jax_state):
  path = jax_ckpt.save_checkpoint(str(tmp_path), 3, jax_state._asdict())
  tiny = torch_config.tiny_config().model
  gqa = params_lib.init_params(
      torch_config.ModelConfig(**{**tiny.__dict__, 'num_kv_heads': 2}))
  with pytest.raises(ValueError, match='shape mismatch'):
    ckpt.restore_params(path, gqa)
  template = params_lib.init_params(tiny)
  del template['decoder']['norm']
  with pytest.raises(ValueError, match='decoder.norm'):
    ckpt.restore_params(path, template)


def test_pt_params_equal_the_saved_state(tmp_path):
  tiny = torch_config.tiny_config()
  tr = trainer.Trainer(tiny.model, tiny.run, seed=3, device='cpu')
  path = tr.save(str(tmp_path))
  got = ckpt.restore_params(path, params_lib.init_params(tiny.model))
  for a, b in zip(params_lib.tree_leaves(got),
                  params_lib.tree_leaves(tr.state.params)):
    assert torch.equal(a, b.detach())


def test_latest_checkpoint_over_both_formats(tmp_path):
  assert ckpt.latest_checkpoint(str(tmp_path / 'absent')) is None
  assert ckpt.latest_checkpoint(str(tmp_path)) is None
  for name in ('checkpoint_3.pt', 'checkpoint_7.pt.tmp', 'checkpoint_x',
               'other_20.pt'):
    (tmp_path / name).write_bytes(b'')
  for name in ('checkpoint_5', 'checkpoint_40.orbax-checkpoint-tmp-1'):
    (tmp_path / name).mkdir()
  assert ckpt.latest_checkpoint(str(tmp_path)) == str(
      tmp_path / 'checkpoint_5')
  assert jax_ckpt.latest_checkpoint(str(tmp_path)) == str(
      tmp_path / 'checkpoint_5')
  (tmp_path / 'checkpoint_12.pt').write_bytes(b'')
  assert ckpt.latest_checkpoint(str(tmp_path)) == str(
      tmp_path / 'checkpoint_12.pt')
  (tmp_path / 'checkpoint_12').mkdir()
  assert ckpt.latest_checkpoint(str(tmp_path)) == str(
      tmp_path / 'checkpoint_12.pt')


def test_missing_tensorstore_is_named(tmp_path, jax_state, monkeypatch):
  path = jax_ckpt.save_checkpoint(str(tmp_path), 1, jax_state._asdict())
  monkeypatch.setitem(sys.modules, 'tensorstore', None)
  with pytest.raises(ImportError, match='tensorstore'):
    ckpt.restore_params(
        path, params_lib.init_params(torch_config.tiny_config().model))


def test_resume_refuses_an_orbax_directory(tmp_path, jax_state):
  path = jax_ckpt.save_checkpoint(str(tmp_path), 2, jax_state._asdict())
  tiny = torch_config.tiny_config()
  tr = trainer.Trainer(tiny.model, tiny.run, device='cpu')
  with pytest.raises(ValueError, match='restore_params'):
    tr.restore(str(tmp_path))
  assert ckpt.latest_checkpoint(str(tmp_path)) == path


# ---------------------------------------------------------------------------
# The entry points on the CPU
# ---------------------------------------------------------------------------
def test_load_transcriber_reads_orbax_and_pt(tmp_path, jax_state):
  jax_ckpt.save_checkpoint(str(tmp_path / 'orbax'), 4, jax_state._asdict())
  t = mt3_tpu_torch.load_transcriber('tiny', str(tmp_path / 'orbax'),
                                     device='cpu')
  assert t.device.type == 'cpu' and t.config.model.dtype == 'bfloat16'
  _leaves_equal(t.params, jax_state.params)

  tiny = torch_config.tiny_config()
  tr = trainer.Trainer(tiny.model, tiny.run, seed=2, device='cpu')
  tr.save(str(tmp_path / 'pt'))
  t = mt3_tpu_torch.load_transcriber('tiny', str(tmp_path / 'pt'), False,
                                     device='cpu')
  for a, b in zip(params_lib.tree_leaves(t.params),
                  params_lib.tree_leaves(tr.state.params)):
    assert torch.equal(a, b.detach())
  with pytest.raises(ValueError, match='not both'):
    mt3_tpu_torch.load_transcriber('tiny', str(tmp_path / 'pt'),
                                   params=t.params, device='cpu')


@pytest.mark.parametrize('gqa', (0, 2))
def test_train_cli_init_from_orbax(tmp_path, jax_state, capsys, gqa):
  """--init_from warm-starts from the JAX package's checkpoint (with
  --gqa_kv_heads 2, mean-pooled K/V heads); at lr 0 one step leaves the
  loaded parameters as they were, so the saved step holds them."""
  from mt3_tpu_torch.cli import train as cli
  jax_ckpt.save_checkpoint(str(tmp_path / 'jax'), 9, jax_state._asdict())
  args = ['--model', 'tiny', '--steps', '1', '--batch_size', '2',
          '--device', 'cpu', '--lr', '0', '--init_from',
          str(tmp_path / 'jax'), '--checkpoint_dir', str(tmp_path / 'out')]
  cli.main(args + (['--gqa_kv_heads', str(gqa)] if gqa else []))
  assert 'warm-started params from' in capsys.readouterr().err
  saved = torch.load(tmp_path / 'out' / 'checkpoint_1.pt',
                     weights_only=True)['params']
  want = params_lib.from_numpy_tree(
      jax.tree_util.tree_map(np.asarray, jax_state.params))
  if gqa:
    tiny = torch_config.tiny_config().model
    want = params_lib.convert_mha_to_gqa(want, tiny.num_heads, tiny.head_dim,
                                         gqa, allow_unfinetuned=True)
  for a, b in zip(params_lib.tree_leaves(saved),
                  params_lib.tree_leaves(want)):
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# T5X
# ---------------------------------------------------------------------------
def _write_zarr(root, name, array, chunks=None, compressor='gzip',
                fill_value=None):
  """A zarr array as T5X writes it (tensorstore, file kvstore); returns
  the relative spec the msgpack holds."""
  dtype = {'float32': '<f4', 'float64': '<f8'}.get(array.dtype.name,
                                                   'bfloat16')
  metadata = {'shape': list(array.shape), 'dtype': dtype,
              'compressor': {'id': compressor} if compressor else None}
  if chunks is not None:
    metadata['chunks'] = list(chunks)
  if fill_value is not None:
    metadata['fill_value'] = fill_value
  ts.open({'driver': 'zarr',
           'kvstore': {'driver': 'file', 'path': os.path.join(root, name)},
           'metadata': metadata}, create=True).result().write(array).result()
  return {'driver': 'zarr', 'kvstore': {'driver': 'file', 'path': name}}


def _t5x_flat(params):
  """Our parameter tree -> {t5x path: array}, the inverse of
  convert_t5x_param_dict."""
  flat = {
      'encoder/continuous_inputs_projection/kernel':
          params['encoder']['input_proj'],
      'encoder/encoder_norm/scale': params['encoder']['norm'],
      'decoder/token_embedder/embedding': params['decoder']['token_embed'],
      'decoder/decoder_norm/scale': params['decoder']['norm'],
      'decoder/logits_dense/kernel': params['decoder']['logits'],
  }
  for side, table in (('encoder', ckpt._T5X_ENCODER_LAYER),
                      ('decoder', ckpt._T5X_DECODER_LAYER)):
    stacked = params[side]['layers']
    for rel, ours in table.items():
      leaf = stacked
      for key in ours:
        leaf = leaf[key]
      for layer in range(leaf.shape[0]):
        flat[f'{side}/layers_{layer}/{rel}'] = leaf[layer]
  return flat


def _write_t5x(root, flat):
  """A T5X checkpoint of `flat`, its leaves in every form: gzip zarr
  (multi-chunk where 2-D), bf16 zarr, zlib and uncompressed zarr, inline
  ndarrays (float32 and bf16) and flax's chunked inline form.  Optimizer
  moments point at directories that do not exist."""
  target, moments = {}, {}
  forms = ('gzip', 'bf16_zarr', 'inline', 'inline_bf16', 'zlib', 'raw',
           'chunked')
  for i, (path, value) in enumerate(sorted(flat.items())):
    value = np.asarray(value, np.float32)
    form = forms[i % len(forms)]
    name = 'target.' + path.replace('/', '.')
    if form == 'gzip':
      chunks = ([max(1, value.shape[0] // 3)] + list(value.shape[1:])
                if value.ndim == 2 else None)
      leaf = _write_zarr(root, name, value, chunks=chunks)
    elif form == 'bf16_zarr':
      leaf = _write_zarr(root, name, value.astype(jnp.bfloat16))
    elif form in ('zlib', 'raw'):
      leaf = _write_zarr(root, name, value,
                         compressor='zlib' if form == 'zlib' else None)
    elif form == 'inline_bf16':
      leaf = value.astype(jnp.bfloat16)
    else:
      leaf = value
    node, mnode = target, moments
    *parents, last = path.split('/')
    for key in parents:
      node, mnode = node.setdefault(key, {}), mnode.setdefault(key, {})
    node[last] = leaf
    mnode[last] = {'driver': 'zarr', 'kvstore': {
        'driver': 'file', 'path': 'state.param_states.' + name + '.v'}}
  tree = {'version': 3, 'optimizer': {
      'target': target, 'state': {'step': 100, 'param_states': moments}}}
  old = serialization.MAX_CHUNK_SIZE
  serialization.MAX_CHUNK_SIZE = 256   # the chunked form for large leaves
  try:
    encoded = serialization.msgpack_serialize(tree)
  finally:
    serialization.MAX_CHUNK_SIZE = old
  assert b'__msgpack_chunked_array__' in encoded
  with open(os.path.join(root, 'checkpoint'), 'wb') as f:
    f.write(encoded)


@pytest.fixture(scope='module')
def t5x_model(tmp_path_factory):
  """The tiny model's JAX params written as a T5X checkpoint."""
  jax_cfg = jax_config.tiny_config().model
  params, _ = jax_t5.init_params(jax.random.PRNGKey(2), jax_cfg)
  params = jax.tree_util.tree_map(np.asarray, params)
  root = str(tmp_path_factory.mktemp('t5x'))
  _write_t5x(root, _t5x_flat(params))
  return root, jax_cfg


def test_t5x_flat_dict_and_tree_equal_jax(t5x_model):
  root, cfg = t5x_model
  want = jax_t5x.load_t5x_checkpoint(root)
  got = t5x_loader.load_t5x_checkpoint(root)
  assert sorted(got) == sorted(want)
  for key in want:
    assert got[key].dtype == want[key].dtype == np.float32, key
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  want_tree = jax_t5x.load_t5x_params(root, cfg.num_encoder_layers,
                                      cfg.num_decoder_layers)
  got_tree = t5x_loader.load_t5x_params(root, cfg.num_encoder_layers,
                                        cfg.num_decoder_layers)
  _leaves_equal(params_lib.from_numpy_tree(got_tree), want_tree)


def test_t5x_model_logits_equal_jax(t5x_model):
  """Teacher-forced logits of the tiny model loaded from T5X, float32."""
  root, jax_cfg = t5x_model
  torch_cfg = torch_config.tiny_config().model
  n_enc, n_dec = jax_cfg.num_encoder_layers, jax_cfg.num_decoder_layers
  jax_params = jax_t5x.load_t5x_params(root, n_enc, n_dec)
  torch_params = params_lib.from_numpy_tree(
      t5x_loader.load_t5x_params(root, n_enc, n_dec))
  rng = np.random.RandomState(4)
  inputs = rng.randn(2, 8, jax_cfg.input_depth).astype(np.float32)
  targets = rng.randint(3, jax_cfg.vocab_size, size=(2, 6)).astype(np.int32)
  dec_in = np.concatenate([np.zeros((2, 1), np.int32), targets[:, :-1]], 1)
  want = jax_t5.forward(jax_params, jax_cfg, inputs, dec_in, targets)
  with torch.no_grad():
    got = t5.forward(torch_params, torch_cfg, torch.from_numpy(inputs),
                     torch.from_numpy(dec_in), torch.from_numpy(targets))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                             rtol=0)


def test_t5x_transcribe_cli(t5x_model, tmp_path, capsys):
  """--t5x_checkpoint and --num_beams on the CPU."""
  import wave
  from mt3_tpu_torch.cli import transcribe as cli
  root, _ = t5x_model
  wav = tmp_path / 'clip.wav'
  pcm = (np.random.RandomState(0).randn(16000) * 3000).astype(np.int16)
  with wave.open(str(wav), 'wb') as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(16000)
    w.writeframes(pcm.tobytes())
  cli.main([str(wav), '--model', 'tiny', '--device', 'cpu',
            '--t5x_checkpoint', root, '--num_beams', '2',
            '--output_dir', str(tmp_path / 'out')])
  assert 'converting t5x checkpoint' in capsys.readouterr().err
  assert (tmp_path / 'out' / 'clip.mid').exists()


def test_t5x_reads_without_tensorstore(t5x_model, monkeypatch, tmp_path):
  """gzip, zlib and raw chunks need only numpy; a blosc array raises an
  ImportError naming the compressor and tensorstore where tensorstore is
  missing, and reads through it where it is installed."""
  root, _ = t5x_model
  want = jax_t5x.load_t5x_checkpoint(root)
  blosc = tmp_path / 'blosc'
  blosc.mkdir()
  value = np.random.RandomState(5).randn(4, 6).astype(np.float32)
  spec = _write_zarr(str(blosc), 'target.w', value, compressor='blosc')
  with open(blosc / 'checkpoint', 'wb') as f:
    f.write(serialization.msgpack_serialize({'target': {'w': spec}}))
  np.testing.assert_array_equal(
      t5x_loader.load_t5x_checkpoint(str(blosc))['w'], value)
  monkeypatch.setitem(sys.modules, 'tensorstore', None)
  got = t5x_loader.load_t5x_checkpoint(root)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  with pytest.raises(ImportError, match="'blosc'.*tensorstore"):
    t5x_loader.load_t5x_checkpoint(str(blosc))


def test_t5x_reader_imports_nothing_but_numpy_and_stdlib():
  import ast
  tree = ast.parse(inspect.getsource(t5x_loader))
  tops = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      tops.update(a.name.split('.')[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      tops.add(node.module.split('.')[0])
  assert tops <= {'__future__', 'gzip', 'itertools', 'json', 'os', 'struct',
                  'zlib', 'typing', 'numpy', 'mt3_tpu_torch'}, tops


# ---------------------------------------------------------------------------
# The decoders against flax and tensorstore
# ---------------------------------------------------------------------------
def test_msgpack_restore_equals_flax(monkeypatch):
  rng = np.random.RandomState(0)
  tree = {
      'f32': rng.randn(3, 4).astype(np.float32),
      'bf16': rng.randn(5).astype(jnp.bfloat16),
      'i64': np.arange(300, dtype=np.int64), 'u8': np.arange(7, dtype=np.uint8),
      'scalar': np.float32(2.5), 'scalar_bf16': jnp.bfloat16(1.25),
      'zero_d': np.array(3.0, np.float64), 'bool': np.bool_(True),
      'ints': [0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**40, -1, -32,
               -33, -128, -129, -2**15 - 1, -2**31 - 1, -2**40],
      'floats': [1.5, -0.25, 1e300], 'none': None, 'flags': [True, False],
      'str': 'x' * 40, 'str16': 'y' * 300, 'str32': 'z' * 70000,
      'bin': b'\x00\x01' * 200, 'complex': complex(1.0, -2.0),
      'map16': {str(i): i for i in range(20)}, 'list16': list(range(20)),
      'nested': {'a': {'b': rng.randn(2, 2).astype(np.float32)}},
  }
  monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
  tree['chunked'] = rng.randn(10, 7).astype(np.float32)
  encoded = serialization.msgpack_serialize(tree)
  want = serialization.msgpack_restore(encoded)
  got = t5x_loader.msgpack_restore(encoded)

  def check(a, b, path):
    if isinstance(a, dict):
      assert sorted(a) == sorted(b), path
      for k in a:
        check(a[k], b[k], f'{path}/{k}')
    elif isinstance(a, (np.ndarray, np.generic)):
      a = np.asarray(a)
      a = a.astype(np.float32) if a.dtype.name == 'bfloat16' else a
      b = np.asarray(b)
      assert a.dtype == b.dtype and a.shape == b.shape, path
      np.testing.assert_array_equal(a, b, err_msg=path)
    else:
      assert type(a) is type(b) and a == b, (path, a, b)

  check(want, got, '')


@pytest.mark.parametrize('case', ('multi_chunk', 'edges_missing', 'zero_d',
                                  'bf16', 'float64', 'zlib', 'raw'))
def test_zarr_reader_equals_tensorstore(tmp_path, case):
  rng = np.random.RandomState(len(case))
  kwargs = {}
  value = rng.randn(7, 5).astype(np.float32)
  if case == 'multi_chunk':
    kwargs['chunks'] = (3, 2)
  elif case == 'edges_missing':
    # Chunks equal to the fill value are not written.
    value[:4] = 0.5
    kwargs.update(chunks=(2, 5), fill_value=0.5)
  elif case == 'zero_d':
    value = np.array(1.75, np.float32)
  elif case == 'bf16':
    value = value.astype(jnp.bfloat16)
    kwargs['chunks'] = (4, 4)
  elif case == 'float64':
    value = value.astype(np.float64)
  else:
    kwargs['compressor'] = 'zlib' if case == 'zlib' else None
  _write_zarr(str(tmp_path), 'a', value, **kwargs)
  if case == 'edges_missing':
    assert len(os.listdir(tmp_path / 'a')) < 1 + 4
  with open(tmp_path / 'a' / '.zarray') as f:
    assert json.load(f)['zarr_format'] == 2
  want = np.asarray(ts.open({'driver': 'zarr', 'kvstore': {
      'driver': 'file', 'path': str(tmp_path / 'a')}}).result().read(
      ).result())
  got = t5x_loader._read_zarr(str(tmp_path / 'a'))
  want = want.astype(np.float32) if case == 'bf16' else want
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Copies pinned to their originals
# ---------------------------------------------------------------------------
def _rewritten(source):
  return source.replace('mt3_tpu.', 'mt3_tpu_torch.')


@pytest.mark.parametrize('ours,theirs,name', [
    (ckpt, jax_ckpt, 'convert_t5x_param_dict'),
    (ckpt, jax_ckpt, 'flatten_params'),
    (t5x_loader, jax_t5x, '_flatten'), (t5x_loader, jax_t5x, '_is_ts_spec'),
    (t5x_loader, jax_t5x, '_find_target'),
    (t5x_loader, jax_t5x, 'load_t5x_params')],
    ids=lambda x: x if isinstance(x, str) else None)
def test_copies_are_pinned_to_their_originals(ours, theirs, name):
  assert inspect.getsource(getattr(ours, name)) == _rewritten(
      inspect.getsource(getattr(theirs, name)))


def test_t5x_tables_equal_and_flatten_params_agrees():
  assert ckpt._T5X_ENCODER_LAYER == jax_ckpt._T5X_ENCODER_LAYER
  assert ckpt._T5X_DECODER_LAYER == jax_ckpt._T5X_DECODER_LAYER
  params = params_lib.to_numpy_tree(
      params_lib.init_params(torch_config.tiny_config().model))
  ours, theirs = ckpt.flatten_params(params), jax_ckpt.flatten_params(params)
  assert list(ours) == list(theirs)
