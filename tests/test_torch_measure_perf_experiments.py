"""mt3_tpu_torch.tools.perf_experiments against tools/perf_experiments.py,
on the CPU: the variants and their configurations, the tokens of 2 beams
over int8_cross at tiny width (each variant's greedy tokens are in
tests/test_torch_measure_perf_tokens.py), the stacked carry's check and
the trace.

Both tools are run through their main() at tiny width (mt3_config
monkeypatched to the tiny preset on both sides), from the same initial
parameters (the port's init_params monkeypatched to JAX's draw) and the
same numpy-seeded frames, with the tokens each pass fetches to the host
recorded (the JAX package's pallas_v3 kernel in interpret mode, as
tests/test_torch_model.py runs it).  The tools decode in bf16; bf16 activations round in another
order in the two packages and move near ties of random tiny weights, so
both are run in float32 (the dtype field replaced the same way on both
sides), where tests/test_torch_decode_modes.py and
tests/test_torch_beam_search.py hold greedy and beam tokens identical.
The JAX tool is loaded from its file; nothing in it is edited.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mt3_tpu.core import config as jax_config
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.tools import perf_experiments
from tests.test_torch_quality_gates import load_jax_tool

torch.set_num_threads(2)

VARIANTS = sorted(perf_experiments.VARIANTS)
BATCH = 2


@pytest.fixture(scope='module')
def jax_tool():
  return load_jax_tool('tools/perf_experiments.py')


class _Recorder:
  """numpy, with asarray recording what it returns."""

  def __init__(self):
    self.arrays = []

  def __getattr__(self, name):
    return getattr(np, name)

  def asarray(self, x, *args, **kwargs):
    out = np.asarray(x, *args, **kwargs)
    self.arrays.append(out)
    return out


class _Built(Exception):
  pass


def test_variants_are_the_jax_tools(jax_tool):
  assert perf_experiments.VARIANTS == jax_tool.VARIANTS
  assert len(VARIANTS) == 14


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('carry', [None, 'stacked'])
def test_variant_config_is_the_jax_tools(jax_tool, monkeypatch, variant,
                                         carry):
  """Field by field the ModelConfig that the JAX tool's main builds
  (stopped at its t5.init_params call); the bucket is printed only."""
  def stop(rng, model_config):
    raise _Built(model_config)
  monkeypatch.setattr(jax_t5, 'init_params', stop)
  argv = ['--variant', variant] + (['--cache_carry', carry] if carry else [])
  monkeypatch.setattr(sys, 'argv', ['perf_experiments.py'] + argv)
  with pytest.raises(_Built) as built:
    jax_tool.main()
  got, bucket = perf_experiments.variant_config(
      variant, torch_config.mt3_config().model, carry)
  assert dataclasses.asdict(got) == dataclasses.asdict(built.value.args[0])
  assert bucket == jax_tool.VARIANTS[variant][2]


def run_both(jax_tool, monkeypatch, argv):
  """(JAX's token arrays, the port's) of one main() run of each tool at
  tiny width in float32 from JAX's initial parameters."""
  monkeypatch.setattr(jax_config, 'mt3_config', jax_config.tiny_config)
  monkeypatch.setattr(torch_config, 'mt3_config', torch_config.tiny_config)
  model_config = jax_config.ModelConfig
  monkeypatch.setattr(jax_config, 'ModelConfig', lambda **kw: model_config(
      **{**kw, 'dtype': 'float32'}))
  variant_config = perf_experiments.variant_config

  def float32(*args, **kwargs):
    model, bucket = variant_config(*args, **kwargs)
    return dataclasses.replace(model, dtype='float32'), bucket
  monkeypatch.setattr(perf_experiments, 'variant_config', float32)

  def jax_draw(model, generator=None, device='cpu'):
    jax_params, _ = jax_t5.init_params(
        jax.random.PRNGKey(0),
        model_config(**dataclasses.asdict(model)))
    return params_lib.from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, jax_params), device)
  monkeypatch.setattr(params_lib, 'init_params', jax_draw)

  recorder = _Recorder()
  monkeypatch.setattr(jax_tool, 'np', recorder)
  monkeypatch.setattr(sys, 'argv', ['perf_experiments.py'] + argv)
  with pltpu.force_tpu_interpret_mode():   # pallas_v3's kernel
    jax_tool.main()
  seen = []
  make = perf_experiments.make_transcribe

  def recording(*args, **kwargs):
    transcribe = make(*args, **kwargs)

    def run(frames):
      tokens = transcribe(frames)
      seen.append(tokens.numpy())
      return tokens
    return run
  monkeypatch.setattr(perf_experiments, 'make_transcribe', recording)
  perf_experiments.main(argv + ['--device', 'cpu'])
  return recorder.arrays, seen


def check_tokens(want, got, batch=BATCH):
  assert len(want) == len(got) == 2
  for w, g in zip(want, got):
    assert g.shape == (batch, jax_config.tiny_config().run.targets_length)
    np.testing.assert_array_equal(g, w)


def test_beam_tokens_match_the_jax_tool(jax_tool, monkeypatch):
  want, got = run_both(jax_tool, monkeypatch, [
      '--variant', 'int8_cross', '--batch', str(BATCH), '--iters', '1',
      '--num_beams', '2'])
  check_tokens(want, got)


def test_pallas_v3_with_the_stacked_carry_raises(jax_tool, monkeypatch):
  """Both tools raise the JAX package's ValueError."""
  monkeypatch.setattr(jax_config, 'mt3_config', jax_config.tiny_config)
  monkeypatch.setattr(torch_config, 'mt3_config', torch_config.tiny_config)
  argv = ['--variant', 'pallas_v3', '--cache_carry', 'stacked', '--batch',
          '1', '--iters', '1']
  monkeypatch.setattr(sys, 'argv', ['perf_experiments.py'] + argv)
  with pytest.raises(ValueError) as want:
    jax_tool.main()
  with pytest.raises(ValueError) as got:
    perf_experiments.main(argv + ['--device', 'cpu'])
  assert str(got.value) == str(want.value)
  assert "decode_cache_carry='stacked'" in str(got.value)


def test_profile_writes_a_gzipped_trace(monkeypatch, tmp_path, capsys):
  monkeypatch.setattr(torch_config, 'mt3_config', torch_config.tiny_config)
  perf_experiments.main(['--variant', 'int4_cross_gqa1', '--batch', '1',
                         '--iters', '1', '--profile', str(tmp_path),
                         '--device', 'cpu'])
  out = capsys.readouterr().out
  assert 'bucket=128 (no effect)' in out and 'profiled iter' in out
  assert [p.name for p in tmp_path.iterdir()] == ['trace.json.gz']


def test_raises_without_cuda():
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present')
  with pytest.raises(RuntimeError, match='CUDA'):
    perf_experiments.main([])
