"""The production decode configuration through the port's serving and
training entry points, against mt3_tpu where the JAX package has the same.

The Transcriber at tiny width with int4 self-attention caches, int8 cross
K/V, one K/V head and the stacked carry gives the JAX Transcriber's tokens
on the same parameters; the transcribe CLI's --int8_kv, --gqa_kv_heads and
--convert_gqa_unfinetuned and the train CLI's --gqa_kv_heads run on the
CPU at tiny width.
"""

import dataclasses
import wave

import jax
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.infer import transcribe as jax_transcribe
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.core import midi_io
from mt3_tpu_torch.infer import transcribe

torch.set_num_threads(2)

PRODUCTION = dict(decode_kv_quantize=True, decode_kv_bits=4,
                  decode_cross_kv_quantize=True, decode_cache_carry='stacked',
                  num_kv_heads=1)


def test_transcriber_production_config_matches_jax():
  """The Transcriber at tiny width in the production decode configuration:
  per-segment tokens identical to the JAX package's over three batches."""
  overrides = dict(PRODUCTION, max_positions=512)
  jax_cfg = jax_config.tiny_config()
  jax_cfg = dataclasses.replace(
      jax_cfg, model=dataclasses.replace(jax_cfg.model, **overrides))
  torch_cfg = torch_config.tiny_config()
  torch_cfg = dataclasses.replace(
      torch_cfg, model=dataclasses.replace(torch_cfg.model, **overrides))
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(0), jax_cfg.model)
  torch_params = params_lib.from_numpy_tree(
      jax.tree_util.tree_map(np.asarray, jax_params))
  rng = np.random.RandomState(0)
  t = np.arange(int(3.0 * 16000)) / 16000
  audio = (0.3 * np.sin(2 * np.pi * 330.0 * t)
           + 0.02 * rng.randn(t.size)).astype(np.float32)
  ref = jax_transcribe.Transcriber(jax_cfg, jax_params).predict_segments(
      audio)
  port = transcribe.Transcriber(torch_cfg, torch_params,
                                device='cpu').predict_segments(audio)
  assert len(port) == len(ref) > 16
  for a, b in zip(port, ref):
    np.testing.assert_array_equal(a['est_tokens'], b['est_tokens'])


def _write_wav(path, seconds=1.0):
  t = np.arange(int(seconds * 16000)) / 16000
  pcm = (0.3 * np.sin(2 * np.pi * 440.0 * t) * 32767).astype(np.int16)
  with wave.open(str(path), 'wb') as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(16000)
    w.writeframes(pcm.tobytes())


@pytest.mark.parametrize('flags,kv_heads', [
    (['--int8_kv', '--gqa_kv_heads', '1'], 1),
    (['--gqa_kv_heads', '2', '--convert_gqa_unfinetuned'], 2),
])
def test_transcribe_cli_decode_flags(tmp_path, monkeypatch, flags, kv_heads):
  """--int8_kv quantizes the self-attention cache and the cross K/V (as the
  JAX CLI sets them); --gqa_kv_heads draws GQA-shaped weights, or with
  --convert_gqa_unfinetuned pools MHA weights."""
  from mt3_tpu_torch.cli import transcribe as cli
  made = []
  make = transcribe.Transcriber

  def spy(*args, **kwargs):
    made.append(make(*args, **kwargs))
    return made[-1]
  monkeypatch.setattr(transcribe, 'Transcriber', spy)
  _write_wav(tmp_path / 'clip.wav')
  cli.main([str(tmp_path / 'clip.wav'), '--model', 'tiny', '--device', 'cpu',
            '--output_dir', str(tmp_path / 'out')] + flags)
  midi_io.midi_file_to_note_sequence(str(tmp_path / 'out' / 'clip.mid'))
  model = made[0].config.model
  int8 = '--int8_kv' in flags
  assert model.kv_heads == kv_heads and model.dtype == 'bfloat16'
  assert model.decode_kv_quantize == model.decode_cross_kv_quantize == int8
  key = made[0].params['decoder']['layers']['self_attention']['key']
  assert key.shape[-1] == kv_heads * model.head_dim


def test_train_cli_gqa(tmp_path, capsys):
  """--gqa_kv_heads 2 trains a tiny model with grouped K/V projections."""
  from mt3_tpu_torch.cli import train as cli
  from mt3_tpu_torch.train import checkpoint as ckpt_lib
  cli.main(['--model', 'tiny', '--steps', '2', '--batch_size', '4',
            '--device', 'cpu', '--gqa_kv_heads', '2', '--checkpoint_dir',
            str(tmp_path)])
  assert 'step 1: loss=' in capsys.readouterr().err
  saved = torch.load(ckpt_lib.latest_checkpoint(str(tmp_path)),
                     weights_only=True)
  leaves = [v for k, v in _flatten(saved['params'])
            if k.endswith('attention/key')]
  assert leaves and all(t.shape[-1] == 2 * 8 for t in leaves)


def _flatten(tree, prefix=''):
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from _flatten(v, f'{prefix}/{k}' if prefix else k)
  else:
    yield prefix, tree
