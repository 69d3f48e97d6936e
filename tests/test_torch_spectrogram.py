"""Log-mel frontend of the PyTorch port vs mt3_tpu.

The plain path (what compute_logmel runs on a CPU tensor, and the plain
version of the log-mel kernel) against the JAX package's XLA path within
atol 1e-4, and against the Pallas TPU kernel it replaces, run in interpret
mode as tests/test_pallas_logmel.py runs it, within atol 5e-3.  The audio
is built as tests/test_spectrogram.py builds it.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mt3_tpu.core.config import SpectrogramConfig as JaxSpectrogramConfig
from mt3_tpu.core import config as jax_config
from mt3_tpu.infer import transcribe as jax_transcribe
from mt3_tpu.ops import spectrogram as jax_spectrogram
from mt3_tpu.ops.pallas import logmel as jax_logmel
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.core.config import SpectrogramConfig
from mt3_tpu_torch.infer import transcribe
from mt3_tpu_torch.ops import logmel, spectrogram

torch.set_num_threads(2)

CONFIG = SpectrogramConfig()
JAX_CONFIG = JaxSpectrogramConfig()


def _audio(n_frames=32, seed=42):
  rng = np.random.RandomState(seed)
  n = n_frames * CONFIG.hop_width
  t = np.arange(n) / CONFIG.sample_rate
  x = (0.5 * np.sin(2 * np.pi * 440 * t)
       + 0.3 * np.sin(2 * np.pi * 1234.5 * t)
       + 0.1 * rng.randn(n))
  return x.astype(np.float32)


def test_frame_signal_matches_jax():
  x = _audio(6)
  ours = spectrogram.frame_signal(torch.from_numpy(x), CONFIG.fft_size,
                                  CONFIG.hop_width)
  theirs = jax_spectrogram.frame_signal(x, JAX_CONFIG.fft_size,
                                        JAX_CONFIG.hop_width)
  assert tuple(ours.shape) == (6, CONFIG.fft_size)
  np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
  with pytest.raises(ValueError):
    spectrogram.frame_signal(torch.zeros(100), CONFIG.fft_size, 128)


def test_dft_and_mel_bases_identical():
  for a, b in zip(spectrogram._windowed_dft_matrices(2048, 2048),
                  jax_spectrogram._windowed_dft_matrices(2048, 2048)):
    np.testing.assert_array_equal(a, b)
  np.testing.assert_array_equal(spectrogram._mel_matrix(CONFIG),
                                jax_spectrogram._mel_matrix(JAX_CONFIG))
  # The kernel's padded bases: the padded bins are zero.
  w_cos, w_sin, mel = logmel.padded_bases(CONFIG, torch.device('cpu'))
  assert w_cos.shape[1] % logmel.FREQ_TILE == 0
  assert w_cos.shape[1] == mel.shape[0] >= CONFIG.fft_size // 2 + 1
  for m in (w_cos[:, 1025:], w_sin[:, 1025:], mel[1025:]):
    assert not m.any()


@pytest.mark.parametrize('shape', [(32,), (2, 32), (3, 1, 8)])
def test_compute_logmel_plain_matches_jax(shape):
  x = np.stack([_audio(shape[-1], seed=i)
                for i in range(int(np.prod(shape[:-1])))])
  x = x.reshape(shape[:-1] + (-1,))
  ours = spectrogram.compute_logmel(torch.from_numpy(x), CONFIG)
  theirs = jax_spectrogram.compute_logmel(x, JAX_CONFIG)
  assert tuple(ours.shape) == shape + (CONFIG.num_mel_bins,)
  np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4)


def test_plain_matches_pallas_kernel():
  x = np.stack([_audio(16, seed=0), 0.5 * _audio(16, seed=1)])
  with pltpu.force_tpu_interpret_mode():
    theirs = np.asarray(jax_logmel.logmel_fused(x, JAX_CONFIG))
  ours = logmel.logmel_fused(torch.from_numpy(x), CONFIG)
  assert ours.shape == theirs.shape == (2, 16, CONFIG.num_mel_bins)
  np.testing.assert_allclose(ours.numpy(), theirs, atol=5e-3)
  # Silence hits the log floor exactly as in the kernel.
  silent = logmel.logmel_fused(torch.zeros(1, 4 * CONFIG.hop_width), CONFIG)
  assert torch.all(silent == float(np.log(np.float32(1e-5))))


def test_split_audio_and_segments_match_jax():
  x = np.random.RandomState(0).randn(1000).astype(np.float32)
  ours = spectrogram.split_audio(x, CONFIG)
  np.testing.assert_array_equal(ours, jax_spectrogram.split_audio(x, JAX_CONFIG))
  flat = spectrogram.flatten_frames(torch.from_numpy(ours))
  np.testing.assert_array_equal(
      flat.numpy(), np.asarray(jax_spectrogram.flatten_frames(ours)))
  audio = np.random.RandomState(1).randn(40000).astype(np.float32)
  jax_cfg, torch_cfg = jax_config.mt3_config(), torch_config.mt3_config()
  ours = transcribe.audio_to_segments(audio, torch_cfg)
  theirs = jax_transcribe.audio_to_segments(audio, jax_cfg)
  assert len(ours) == len(theirs)
  for a, b in zip(ours, theirs):
    np.testing.assert_array_equal(a.frames, b.frames)
    assert a.start_times == b.start_times and a.valid == b.valid
