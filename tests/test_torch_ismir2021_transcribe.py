"""The ismir2021 flavour's Transcriber in the port against mt3_tpu's, on
the CPU, at the tiny preset's widths (the model of
tests/test_torch_ismir2021.py): tokens and notes identical on a 10 s clip,
three 512-frame segments decoded to the flavour's 1024 targets, no ties,
flat programs, 127 velocities."""

import dataclasses

import numpy as np
import torch

from mt3_tpu.infer import transcribe as jax_transcribe
from mt3_tpu_torch.infer import transcribe
from tests.test_torch_ismir2021 import models  # noqa: F401  (fixture)

torch.set_num_threads(2)


def _clip(seconds, seed=0):
  """A chord of three sines, then another, with a little noise."""
  rng = np.random.RandomState(seed)
  t = np.arange(int(seconds * 16000)) / 16000
  audio = np.zeros_like(t)
  for start, freqs in ((0.0, (261.6, 329.6, 392.0)),
                       (seconds / 2, (220.0, 277.2, 329.6))):
    window = (t >= start) & (t < start + seconds / 2)
    audio += sum(0.2 * window * np.sin(2 * np.pi * f * t) for f in freqs)
  return (audio + 0.02 * rng.randn(t.size)).astype(np.float32)


def test_transcriber_matches_jax(models):  # noqa: F811
  jax_cfg, jax_params, cfg, params = models
  audio = _clip(10.0)
  ref = jax_transcribe.Transcriber(jax_cfg, jax_params)
  port = transcribe.Transcriber(cfg, params, device='cpu')
  ref_pred, port_pred = ref.predict_segments(audio), port.predict_segments(
      audio)
  assert len(port_pred) == len(ref_pred) == 3
  for a, b in zip(port_pred, ref_pred):
    np.testing.assert_array_equal(a['est_tokens'], b['est_tokens'])
    assert a['start_time'] == b['start_time']
  ref_ns, port_ns = ref(audio), port(audio)
  assert ref_ns.notes and any(n.velocity != ref_ns.notes[0].velocity
                              for n in ref_ns.notes)
  assert ([dataclasses.astuple(n) for n in port_ns.notes]
          == [dataclasses.astuple(n) for n in ref_ns.notes])
