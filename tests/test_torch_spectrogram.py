"""Log-mel frontend of the PyTorch port vs mt3_tpu.

The plain path (what compute_logmel runs on a CPU tensor, and the plain
version of the log-mel kernel) against the JAX package's XLA path within
atol 1e-4, and against the Pallas TPU kernel it replaces, run in interpret
mode as tests/test_pallas_logmel.py runs it, within atol 5e-3.  The audio
is built as tests/test_spectrogram.py builds it.  The CUDA kernel's tables
and a numpy mirror of its packed FFT are checked here too; its wrapper is
run up to the library's door against a fake library.
"""

import types

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
from mt3_tpu_torch.ops import cuda_build, logmel, spectrogram

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
  # The kernel's tables: the bands rebuild the mel matrix exactly, the
  # window is the float32 Hann window, the twiddles are numpy's to float32
  # rounding.
  tables = logmel.kernel_tables(CONFIG, torch.device('cpu'))
  mel = spectrogram._mel_matrix(CONFIG)
  rebuilt = np.zeros_like(mel)
  for m, (first, count) in enumerate(tables.bands.numpy()):
    rebuilt[first:first + count, m] = tables.weights.numpy()[:count, m]
    assert not tables.weights.numpy()[count:, m].any()
  np.testing.assert_array_equal(rebuilt, mel)
  assert tables.bands.dtype == torch.int32
  assert int(tables.bands[:, 1].max()) == tables.weights.shape[0] <= 10
  np.testing.assert_array_equal(
      tables.window.numpy(),
      spectrogram.hann_window(CONFIG.fft_size).astype(np.float32))
  c, b = np.meshgrid(np.arange(32), np.arange(32), indexing='ij')
  want = np.exp(-2j * np.pi * np.concatenate(
      [np.arange(16) / 32, (b * c).reshape(-1) / 1024,
       np.arange(1025) / 2048]))
  got = tables.twiddles.numpy()
  assert got.dtype == np.float32 and got.shape == (16 + 1024 + 1025, 2)
  np.testing.assert_allclose(got[:, 0], want.real, rtol=0, atol=2.0**-24)
  np.testing.assert_allclose(got[:, 1], want.imag, rtol=0, atol=2.0**-24)


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


# ---------------------------------------------------------------------------
# The CUDA kernel's algorithm (csrc/logmel.cu) mirrored in numpy, float32.
# ---------------------------------------------------------------------------
def _bitrev5(k):
  return ((k & 1) << 4) | ((k & 2) << 2) | (k & 4) | ((k & 8) >> 2) | (
      (k & 16) >> 4)


def _fft32(v, tw32):
  """The kernel's in-register radix-2 DIF FFT over the last axis (32);
  returns the output in natural order."""
  v = v.copy()
  for stage in range(5):
    span = 16 >> stage
    for g in range(0, 32, 2 * span):
      for j in range(span):
        a, b = v[..., g + j].copy(), v[..., g + j + span].copy()
        v[..., g + j] = a + b
        e = j << stage
        v[..., g + j + span] = (a - b) if e == 0 else (a - b) * tw32[e]
  return v[..., [_bitrev5(k) for k in range(32)]]


def _kernel_mirror(audio, config, eps=1e-5):
  """Window, packed 1024-point complex FFT as 32 x 32 (four-step), split
  step to |rfft_2048|, banded mel in ascending bin order, safe log: the
  kernel's steps on the kernel's tables."""
  tables = logmel.kernel_tables(config, torch.device('cpu'))
  tw = tables.twiddles.numpy()
  tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
  tw32, step, split = tw[:16], tw[16:1040].reshape(32, 32), tw[1040:]
  frames = spectrogram.frame_signal(torch.from_numpy(audio), config.fft_size,
                                    config.hop_width).numpy()
  xw = frames * tables.window.numpy()
  z = (xw[..., 0::2] + 1j * xw[..., 1::2]).astype(np.complex64)
  # Lane b holds z[32 a + b]; FFT over a; times W_1024^(b c); transpose.
  y = _fft32(np.swapaxes(z.reshape(z.shape[:-1] + (32, 32)), -1, -2), tw32)
  y = np.swapaxes(y * step.T, -1, -2)        # lane c holds b
  big_z = np.swapaxes(_fft32(y, tw32), -1, -2).reshape(z.shape)  # Z[c + 32 d]
  k = np.arange(512)
  za, zb, t = big_z[..., k], big_z[..., (1024 - k) % 1024], split[k]
  ex, ey = za.real + zb.real, za.imag - zb.imag
  ox, oy = za.real - zb.real, za.imag + zb.imag
  p, q = t.real * oy + t.imag * ox, t.real * ox - t.imag * oy
  mag = np.zeros(z.shape[:-1] + (1025,), np.float32)
  mag[..., k] = 0.5 * np.sqrt((ex + p) ** 2 + (ey - q) ** 2)
  mag[..., 1024 - k] = 0.5 * np.sqrt((ex - p) ** 2 + (ey + q) ** 2)
  mag[..., 512] = np.abs(big_z[..., 512])
  weights = tables.weights.numpy()
  acc = np.zeros(mag.shape[:-1] + (config.num_mel_bins,), np.float32)
  for m, (first, count) in enumerate(tables.bands.numpy()):
    for i in range(count):
      acc[..., m] += weights[i, m] * mag[..., first + i]
  log_eps = np.float32(np.log(np.float64(np.float32(eps))))
  with np.errstate(divide='ignore'):
    return np.where(acc <= 0, log_eps, np.log(acc)).astype(np.float32)


def test_kernel_mirror_matches_plain_and_float64():
  """The FFT algorithm against the plain version within the kernel's 5e-3,
  and against a float64 rfft log-mel (the plain version's dense DFT is the
  less exact of the two); silence gives log(eps) exactly."""
  x = np.stack([_audio(40, seed=3), 0.5 * _audio(40, seed=4)])
  got = _kernel_mirror(x, CONFIG)
  want = logmel.logmel_plain(torch.from_numpy(x), CONFIG).numpy()
  assert got.shape == want.shape == (2, 40, CONFIG.num_mel_bins)
  np.testing.assert_allclose(got, want, atol=5e-3)
  frames = spectrogram.frame_signal(torch.from_numpy(x).double(),
                                    CONFIG.fft_size, CONFIG.hop_width).numpy()
  mel = np.abs(np.fft.rfft(frames * spectrogram.hann_window(
      CONFIG.fft_size))) @ spectrogram._mel_matrix(CONFIG).astype(np.float64)
  truth = np.log(np.where(mel <= 0, 1e-5, mel))
  assert np.abs(got - truth).max() < 1e-4
  silent = _kernel_mirror(np.zeros((1, 4 * CONFIG.hop_width), np.float32),
                          CONFIG)
  assert np.all(silent == np.float32(np.log(np.float32(1e-5))))


class _FakeLogmel:
  """mt3_logmel that records its arguments and reports success."""

  def __init__(self):
    self.argtypes, self.calls = None, []

  def __call__(self, *args):
    self.calls.append(args)
    return 0


@pytest.fixture
def fake_logmel(monkeypatch):
  """CPU tensors pass for CUDA ones and the built library is a fake: the
  wrapper runs up to the kernel's door."""
  entry = _FakeLogmel()
  monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda self: True))
  monkeypatch.setattr(logmel, '_stream', lambda t: 0)
  monkeypatch.setattr(cuda_build, 'library',
                      lambda name: types.SimpleNamespace(mt3_logmel=entry))
  before = logmel.LAUNCHES
  yield entry
  logmel.LAUNCHES = before


def test_kernel_wrapper_arguments(fake_logmel):
  x = torch.zeros(3, 2, 37 * CONFIG.hop_width)
  launches = logmel.LAUNCHES
  out = logmel._launch(x, CONFIG, 1e-5)
  (args,) = fake_logmel.calls
  tables = logmel.kernel_tables(CONFIG, x.device)
  assert args[:6] == (x.data_ptr(), tables.window.data_ptr(),
                      tables.twiddles.data_ptr(), tables.bands.data_ptr(),
                      tables.weights.data_ptr(), out.data_ptr())
  assert args[6:11] == (6, 37 * CONFIG.hop_width, CONFIG.hop_width, 2048,
                        CONFIG.num_mel_bins)
  assert args[11] == float(np.log(np.float32(1e-5)).astype(np.float32))
  assert args[12] == 0
  assert out.shape == (3, 2, 37, CONFIG.num_mel_bins)
  assert out.dtype == torch.float32
  assert logmel.LAUNCHES == launches + 1
  for bad in (x.double(), x.transpose(0, 1),
              torch.zeros(2, 37 * CONFIG.hop_width - 64)):
    with pytest.raises(ValueError):
      logmel._launch(bad, CONFIG, 1e-5)
  assert len(fake_logmel.calls) == 1 and logmel.LAUNCHES == launches + 1
