"""PyTorch port vs mt3_tpu: decode loop, Transcriber and CLI at tiny width.

Inputs are made with numpy from a seed; the JAX parameters go through
params.from_numpy_tree.  Token streams and notes must be identical.
"""

import dataclasses
import wave

import jax
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.infer import decode as jax_decode
from mt3_tpu.infer import transcribe as jax_transcribe
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.codec import vocabulary
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.core import midi_io
from mt3_tpu_torch.infer import decode, transcribe

torch.set_num_threads(2)


def _tiny(config_lib):
  config = config_lib.tiny_config()
  return dataclasses.replace(
      config, model=dataclasses.replace(config.model, max_positions=512))


@pytest.fixture(scope='module')
def models():
  jax_cfg = _tiny(jax_config)
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(0), jax_cfg.model)
  numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
  return (jax_cfg, jax_params, _tiny(torch_config),
          params_lib.from_numpy_tree(numpy_params))


@pytest.fixture(scope='module')
def encoded(models):
  jax_cfg, _, torch_cfg, _ = models
  rng = np.random.RandomState(0)
  return rng.randn(4, 8, jax_cfg.model.emb_dim).astype(np.float32)


@pytest.mark.parametrize('max_len,forbid_eos,steps_per_iter', [
    (16, False, 1),
    (300, True, 16),   # crosses JAX's bucket edges 128 and 256; gcd 4
    (40, False, 16),   # gcd clamps to 8
])
def test_decode_tokens_matches_jax(models, encoded, max_len, forbid_eos,
                                   steps_per_iter):
  jax_cfg, jax_params, torch_cfg, torch_params = models
  ref_tokens, ref_lengths = jax_decode.decode_tokens(
      jax_params, jax_cfg.model, encoded, max_len, forbid_eos=forbid_eos,
      steps_per_iter=steps_per_iter)
  tokens, lengths = decode.decode_tokens(
      torch_params, torch_cfg.model, torch.from_numpy(encoded), max_len,
      forbid_eos=forbid_eos, steps_per_iter=steps_per_iter)
  np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
  np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_lengths))
  assert tokens.dtype == torch.int32 and lengths.dtype == torch.int32
  if forbid_eos:
    assert np.all(lengths.numpy() == max_len)


def _audio(seconds: float, seed: int = 0) -> np.ndarray:
  rng = np.random.RandomState(seed)
  t = np.arange(int(seconds * 16000)) / 16000
  x = sum(0.2 * np.sin(2 * np.pi * f * t) for f in (261.6, 329.6, 392.0))
  return (x + 0.02 * rng.randn(t.size)).astype(np.float32)


def test_transcriber_matches_jax(models):
  jax_cfg, jax_params, torch_cfg, torch_params = models
  audio = _audio(3.0)
  ref = jax_transcribe.Transcriber(jax_cfg, jax_params)
  port = transcribe.Transcriber(torch_cfg, torch_params, device='cpu')
  ref_pred = ref.predict_segments(audio)
  port_pred = port.predict_segments(audio)
  assert len(port_pred) == len(ref_pred) > 8  # several segment batches
  for a, b in zip(port_pred, ref_pred):
    np.testing.assert_array_equal(a['est_tokens'], b['est_tokens'])
    assert a['start_time'] == b['start_time']
  ref_ns = ref.transcribe(audio)['est_ns']
  port_ns = port.transcribe(audio)['est_ns']
  assert ref_ns.notes
  assert ([dataclasses.astuple(n) for n in port_ns.notes]
          == [dataclasses.astuple(n) for n in ref_ns.notes])


def test_audio_to_segments_matches_jax(models):
  jax_cfg, _, torch_cfg, _ = models
  audio = _audio(1.3, seed=3)
  for overlap in (0, 2):
    ref = jax_transcribe.audio_to_segments(audio, jax_cfg, overlap)
    port = transcribe.audio_to_segments(audio, torch_cfg, overlap)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
      np.testing.assert_array_equal(a.frames, b.frames)
      assert a.start_times == b.start_times and a.valid == b.valid


def test_temperature_sampling(models, encoded):
  _, _, torch_cfg, torch_params = models
  x = torch.from_numpy(encoded)

  def sample(seed):
    g = torch.Generator().manual_seed(seed)
    return decode.decode_tokens(torch_params, torch_cfg.model, x, 24,
                                temperature=1.0, generator=g)

  t1, l1 = sample(7)
  t2, l2 = sample(7)
  t3, _ = sample(8)
  assert torch.equal(t1, t2) and torch.equal(l1, l2)
  assert not torch.equal(t1, t3)
  for row, n in zip(t1.numpy(), l1.numpy()):
    assert np.all(row[:n] != vocabulary.PAD_ID)
    assert np.all(row[n:] == vocabulary.PAD_ID)


def test_cli_writes_midi(tmp_path):
  from mt3_tpu_torch.cli import transcribe as cli
  wav_path = tmp_path / 'clip.wav'
  pcm = np.clip(_audio(1.0, seed=5) * 32767, -32768, 32767).astype(np.int16)
  with wave.open(str(wav_path), 'wb') as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(16000)
    w.writeframes(pcm.tobytes())
  cli.main([str(wav_path), '--model', 'tiny', '--device', 'cpu',
            '--output_dir', str(tmp_path / 'out')])
  ns = midi_io.midi_file_to_note_sequence(str(tmp_path / 'out' / 'clip.mid'))
  assert ns.total_time >= 0.0
  with pytest.raises(FileNotFoundError, match='no checkpoint at'):
    cli.main([str(wav_path), '--model', 'tiny', '--device', 'cpu',
              '--checkpoint', str(tmp_path)])
