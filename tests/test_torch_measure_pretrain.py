"""mt3_pretrain's training step in the port against the JAX package's, on
the CPU at tiny width.

mt3_pretrain_config's run (label smoothing 0.1, mixes of up to 8
examples) with the tiny model and lengths, batch 4, warm-up 1: two
Trainer steps with num_microbatches=2 on batches of the mixing pipeline
(the port's; tests/test_torch_measure_host.py holds its first mixed batch
bit-equal to JAX's), from the same initial state.  Tolerances are
tests/test_torch_train.py's: parameters within 1e-6, Adafactor
statistics within 1e-5 of each leaf's largest, metrics within 1e-5
relative.
"""

import dataclasses

import jax
import numpy as np
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.train import trainer as jax_trainer
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.codec import vocabulary
from mt3_tpu_torch.core import config
from mt3_tpu_torch.data import datasets, pipeline
from mt3_tpu_torch.train import trainer
from tests.test_torch_train import _numpy_state

torch.set_num_threads(2)


def _pretrain_tiny(config_lib):
  pretrain = config_lib.mt3_pretrain_config()
  tiny = config_lib.tiny_config()
  run = dataclasses.replace(
      pretrain.run, inputs_length=tiny.run.inputs_length,
      targets_length=tiny.run.targets_length, batch_size=4, warmup_steps=1)
  return dataclasses.replace(tiny, run=run)


def test_pretrain_steps_with_microbatches_match_jax():
  port_cfg, jax_cfg = _pretrain_tiny(config), _pretrain_tiny(jax_config)
  run = port_cfg.run
  assert (run.label_smoothing, run.max_examples_per_mix) == (0.1, 8)
  assert dataclasses.asdict(jax_cfg.run) == dataclasses.asdict(run)

  codec = vocabulary.build_codec(port_cfg.vocab)
  source = datasets.resolve_data_source('synthetic', port_cfg.spectrogram,
                                        num_examples=6, seed=0)
  raw = pipeline.train_batches(
      source.examples(), port_cfg.spectrogram, codec,
      vocabulary.vocabulary_from_codec(codec),
      pipeline.TrainPipelineConfig(
          inputs_length=run.inputs_length,
          targets_length=run.targets_length, batch_size=run.batch_size,
          onsets_only=run.onsets_only, include_ties=run.use_ties,
          program_granularity=run.program_granularity,
          max_examples_per_mix=run.max_examples_per_mix, seed=0))
  batches = [{k: v.numpy() for k, v in trainer.model_batch(
      next(raw), port_cfg.spectrogram, 'cpu').items()} for _ in range(2)]

  jax_tr = jax_trainer.Trainer(model_config=jax_cfg.model,
                               run_config=jax_cfg.run, num_microbatches=2)
  tr = trainer.Trainer(port_cfg.model, run, num_microbatches=2,
                       device='cpu')
  trainer.load_state_tree(tr.state, _numpy_state(jax_tr.state))
  for batch in batches:
    want_metrics = jax_tr.step(batch)
    metrics = tr.step(batch)
    want = _numpy_state(jax_tr.state)
    got = trainer.state_tree(tr.state)
    assert got['step'] == int(want['step'])
    for g, w in zip(params_lib.tree_leaves(got['params']),
                    params_lib.tree_leaves(want['params'])):
      np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
    for name in ('v_row', 'v_col', 'v_full'):
      for g, w in zip(params_lib.tree_leaves(got['opt_state'][name]),
                      params_lib.tree_leaves(want['opt_state'][name])):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert set(metrics) == set(want_metrics)
    for key, value in want_metrics.items():
      np.testing.assert_allclose(float(metrics[key]), float(value),
                                 rtol=1e-5, err_msg=key)
  assert float(metrics['learning_rate']) == np.float32(run.learning_rate)
