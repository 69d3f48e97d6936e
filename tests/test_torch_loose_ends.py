"""The last functions of modules already ported, against mt3_tpu on the CPU.

  * ops/spectrogram.compute_spectrogram and compute_logmel(method=):
    each float32 log-mel is held to a float64 one (numpy's rfft of the
    windowed frames, the mel matrix, the safe log), the port within 1e-4
    and within twice JAX's own error, and the two packages within 2e-4 of
    each other (tests/test_torch_pipeline.py's scheme: both sum float32
    products in a thread-dependent order).  On a CUDA tensor both methods
    run kernel A (an FFT log-mel); an unknown method raises ValueError in
    both packages.
  * infer/decode.encode_and_decode: the same tokens and lengths as JAX at
    the tiny preset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.infer import decode as jax_decode
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu.ops import spectrogram as jax_spectrogram
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config
from mt3_tpu_torch.infer import decode
from mt3_tpu_torch.ops import logmel, spectrogram


def _samples():
  cfg = config.SpectrogramConfig()
  return (np.random.RandomState(0).randn(2, 64 * cfg.hop_width)
          * 0.3).astype(np.float32)


def _logmel_float64(samples, cfg):
  hop, fft = cfg.hop_width, cfg.fft_size
  padded = np.pad(samples.astype(np.float64), [(0, 0), (0, fft - hop)])
  windows = np.lib.stride_tricks.sliding_window_view(
      padded, fft, axis=-1)[:, ::hop]
  mel = np.abs(np.fft.rfft(windows * spectrogram.hann_window(fft))) @ (
      spectrogram._mel_matrix(cfg).astype(np.float64))
  return np.log(np.where(mel <= 0, 1e-5, mel))


def _hold(got, want, truth):
  port_err = np.abs(got - truth).max()
  jax_err = np.abs(want - truth).max()
  assert port_err <= 1e-4, port_err
  assert port_err <= 2 * jax_err, (port_err, jax_err)
  np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize('method', ('matmul', 'fft'))
def test_compute_logmel_methods_match_jax(method):
  cfg = config.SpectrogramConfig()
  samples = _samples()
  want = np.asarray(jax_spectrogram.compute_logmel(
      jnp.asarray(samples), jax_config.SpectrogramConfig(), method=method))
  got = spectrogram.compute_logmel(torch.from_numpy(samples), cfg,
                                   method=method).numpy()
  assert got.shape == want.shape == (2, 64, cfg.num_mel_bins)
  _hold(got, want, _logmel_float64(samples, cfg))


def test_compute_spectrogram_matches_jax():
  cfg = config.SpectrogramConfig()
  samples = _samples()
  want = np.asarray(jax_spectrogram.compute_spectrogram(
      jnp.asarray(samples), jax_config.SpectrogramConfig()))
  got = spectrogram.compute_spectrogram(torch.from_numpy(samples),
                                        cfg).numpy()
  _hold(got, want, _logmel_float64(samples, cfg))


def test_unknown_method_raises():
  samples = _samples()
  with pytest.raises(ValueError, match='unknown stft method'):
    jax_spectrogram.compute_logmel(jnp.asarray(samples),
                                   jax_config.SpectrogramConfig(),
                                   method='dct')
  with pytest.raises(ValueError, match='unknown stft method'):
    spectrogram.compute_logmel(torch.from_numpy(samples),
                               config.SpectrogramConfig(), method='dct')


@pytest.mark.parametrize('method', ('matmul', 'fft'))
def test_device_tensor_takes_kernel_a_under_both_methods(monkeypatch,
                                                         method):
  """A tensor off the CPU (a meta tensor here, which takes the same branch
  as a CUDA one) goes to logmel.logmel_fused, the wrapper that launches
  kernel A, whichever the method."""
  calls = []
  monkeypatch.setattr(logmel, 'logmel_fused',
                      lambda samples, cfg: calls.append(samples.device))
  samples = torch.empty((2, 64 * 128), device='meta')
  spectrogram.compute_logmel(samples, config.SpectrogramConfig(),
                             method=method)
  assert calls == [torch.device('meta')]


@pytest.mark.parametrize('max_len', (16, 40))
def test_encode_and_decode_matches_jax(max_len):
  jax_cfg = jax_config.tiny_config()
  port_cfg = config.tiny_config()
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(0), jax_cfg.model)
  params = params_lib.from_numpy_tree(
      jax.tree_util.tree_map(np.asarray, jax_params))
  inputs = np.random.RandomState(1).randn(
      3, jax_cfg.run.inputs_length, jax_cfg.model.input_depth).astype(
          np.float32)
  want_tokens, want_lengths = jax_decode.encode_and_decode(
      jax_params, jax_cfg.model, jnp.asarray(inputs), max_len)
  tokens, lengths = decode.encode_and_decode(
      params, port_cfg.model, torch.from_numpy(inputs), max_len)
  np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
  np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_lengths))
