"""mt3_tpu_torch.bench against bench.py, on the CPU.

The port's bench builds bench.py's decode configuration field by field;
its device program (make_transcribe) gives the tokens and lengths of
bench.py's jitted composition (bench.py:147-155) at tiny width on the
same parameters, identical as tests/test_torch_decode_serving.py holds
the production configuration; its corpus frames are bench.py's, bit for
bit; in checkpoint mode (an orbax checkpoint written by the JAX package,
or the port's .pt) it prints bench.py's JSON keys, with bench.py's mean
decode length on the same checkpoint and audio.  bench.py is loaded from
its file with its tiny-width monkeypatches; nothing in it is edited.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.infer import decode as jax_decode
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu.ops import spectrogram as jax_spectrogram
from mt3_tpu.train import checkpoint as jax_ckpt
from mt3_tpu_torch import bench
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.tools import make_corpus
from mt3_tpu_torch.train import trainer
from tests.test_torch_quality_gates import load_jax_tool

torch.set_num_threads(2)

SEGMENTS = 4


@pytest.fixture(scope='module')
def jax_bench():
  return load_jax_tool('bench.py')


class _Built(Exception):
  pass


def _jax_model_config(jax_bench, monkeypatch, argv):
  """The ModelConfig that bench.py's main builds for argv (stopped at its
  t5.init_params call)."""
  def stop(rng, model_config):
    raise _Built(model_config)
  monkeypatch.setattr(jax_t5, 'init_params', stop)
  with pytest.raises(_Built) as built:
    jax_bench.main(argv)
  return built.value.args[0]


@pytest.mark.parametrize('kv_heads', [1, 0])
def test_model_config_is_bench_py_s(jax_bench, monkeypatch, kv_heads):
  want = _jax_model_config(jax_bench, monkeypatch,
                           ['--kv_heads', str(kv_heads)])
  got = bench.model_config(kv_heads)
  assert dataclasses.asdict(got) == dataclasses.asdict(want)
  assert got.kv_heads == (kv_heads or got.num_heads)


def test_constants_are_bench_py_s(jax_bench):
  for name in ('NUM_SEGMENTS', 'STEPS_PER_ITER', 'WARMUP_ITERS',
               'TIMED_ITERS', 'BASELINE_AUDIO_SEC_PER_SEC'):
    assert getattr(bench, name) == getattr(jax_bench, name), name


def _tiny_pair(kv_heads, **overrides):
  """(JAX params, port params, port model config, JAX model config) of
  bench's configuration at tiny width, with `overrides`."""
  model = dataclasses.replace(
      bench.model_config(kv_heads, torch_config.tiny_config().model),
      **overrides)
  jax_model = jax_config.ModelConfig(**dataclasses.asdict(model))
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(3), jax_model)
  jax_params = jax.tree_util.tree_map(np.asarray, jax_params)
  return jax_params, params_lib.from_numpy_tree(jax_params), model, jax_model


@pytest.mark.parametrize('kv_heads', [1, 0])
def test_make_transcribe_matches_bench_py(kv_heads):
  """In float32 (bench's other fields kept): bf16 activations round in
  another order in the two packages and move near ties of random tiny
  weights, so token identity is held in float32, as
  tests/test_torch_decode_serving.py holds the production configuration."""
  jax_params, params, model, jax_model = _tiny_pair(kv_heads,
                                                    dtype='float32')
  tiny = torch_config.tiny_config()
  jtiny = jax_config.tiny_config()
  frames = bench.random_frames(tiny.spectrogram, tiny.run.inputs_length,
                               SEGMENTS)

  @jax.jit
  def transcribe(params, frames):   # bench.py:147-155
    mel = jax_spectrogram.compute_logmel(
        jax_spectrogram.flatten_frames(frames), jtiny.spectrogram)
    encoded = jax_t5.encode(params, jax_model, mel)
    return jax_decode.decode_tokens(
        params, jax_model, encoded, jtiny.run.targets_length,
        forbid_eos=True, steps_per_iter=bench.STEPS_PER_ITER)

  want_tokens, want_lengths = transcribe(jax_params, frames)
  tokens, lengths = bench.make_transcribe(
      params, model, tiny.spectrogram, tiny.run, forbid_eos=True)(
          torch.from_numpy(frames))
  np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
  np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_lengths))
  assert int(lengths.min()) == tiny.run.targets_length


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
  root = tmp_path_factory.mktemp('corpus')
  make_corpus.main(['--out', str(root), '--num', '1', '--num_validation',
                    '3', '--num_test', '1', '--duration', '2.048'])
  return root


@pytest.mark.parametrize('segments', [2, 5])
def test_corpus_frames_equal_bench_py_s(jax_bench, corpus, segments):
  """Frames of 3 held-out clips, cut and tiled to the batch: bit-equal."""
  spec = torch_config.mt3_config().spectrogram
  got = bench._corpus_frames(str(corpus / 'validation'), spec, 64, segments)
  want = jax_bench._corpus_frames(str(corpus / 'validation'),
                                  jax_config.mt3_config().spectrogram, 64,
                                  segments)
  assert got.shape == (segments, 64, spec.hop_width)
  assert got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)


def test_bench_raises_without_cuda():
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present')
  with pytest.raises(RuntimeError, match='CUDA'):
    bench.main([])


def test_default_mode_prints_passes_and_json(monkeypatch, capsys):
  monkeypatch.setattr(bench, 'NUM_SEGMENTS', SEGMENTS)
  monkeypatch.setattr(torch_config, 'mt3_config', torch_config.tiny_config)
  bench.main(['--device', 'cpu'])
  lines = capsys.readouterr().out.strip().splitlines()
  assert lines[0].startswith('device: cpu')
  assert lines[1].startswith('timed passes: ') and lines[1].count(',') == (
      bench.TIMED_ITERS - 1)
  result = json.loads(lines[-1])
  assert list(result) == ['metric', 'value', 'unit', 'vs_baseline']
  assert result['metric'] == 'audio_sec_transcribed_per_sec_per_chip'
  assert result['value'] > 0


def test_checkpoint_mode_prints_bench_py_s_keys(jax_bench, corpus, tmp_path,
                                                monkeypatch, capsys):
  """--checkpoint on an orbax checkpoint of the JAX package: bench.py's
  keys, mode and mean decode length (EOS live, the same tokens); on the
  port's .pt: the same keys."""
  jax_params, _, model, _ = _tiny_pair(1)
  path = jax_ckpt.save_checkpoint(str(tmp_path / 'orbax'), 3,
                                  {'params': jax_params})
  monkeypatch.setattr(jax_bench, 'NUM_SEGMENTS', SEGMENTS)
  monkeypatch.setattr(jax_config, 'mt3_config', jax_config.tiny_config)
  monkeypatch.setattr(bench, 'NUM_SEGMENTS', SEGMENTS)
  monkeypatch.setattr(torch_config, 'mt3_config', torch_config.tiny_config)
  argv = ['--checkpoint', str(tmp_path / 'orbax'), '--audio',
          str(corpus / 'validation')]
  jax_bench.main(argv)
  want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  bench.main(argv + ['--device', 'cpu'])
  got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert list(got) == list(want) == ['metric', 'value', 'unit',
                                     'vs_baseline', 'mode',
                                     'mean_decode_len']
  assert got['mode'] == want['mode'] == 'trained+eos_exit'
  assert got['mean_decode_len'] == want['mean_decode_len']
  assert path.endswith('checkpoint_3')

  tiny = torch_config.tiny_config()
  tr = trainer.Trainer(model, tiny.run, seed=1, device='cpu')
  tr.save(str(tmp_path / 'pt'))
  bench.main(['--checkpoint', str(tmp_path / 'pt'), '--audio',
              str(corpus / 'validation'), '--device', 'cpu'])
  pt = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert list(pt) == list(want)
