"""The port's velocity diagnosis against tools/velocity_diagnosis.py, on
the CPU: both tools' main on one orbax checkpoint written by the JAX
package (the tiny preset, 1 velocity bin), and the 127-bin branch
(confusion, MAE) with both tools' checkpoint loads and Transcribers
replaced by the same canned transcriptions, so that the diagnosis itself
is compared.  The printed JSON must be equal.  The JAX tool is loaded from
tools/; nothing there is edited."""

import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.data import datasets as jax_datasets
from mt3_tpu.train import checkpoint as jax_ckpt
from mt3_tpu.train import trainer as jax_trainer
from mt3_tpu_torch.data import datasets as port_datasets
from mt3_tpu_torch.tools import make_corpus, velocity_diagnosis
from tests.test_torch_quality_gates import load_jax_tool

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def orbax_dir(tmp_path_factory):
  """A tiny train state saved by the JAX package (orbax)."""
  state, _ = jax_trainer.init_train_state(jax.random.PRNGKey(0),
                                          jax_config.tiny_config().model)
  directory = tmp_path_factory.mktemp('orbax')
  jax_ckpt.save_checkpoint(str(directory), 3, state._asdict())
  return directory


def _jax_main(module, argv, monkeypatch, capsys):
  monkeypatch.setattr(sys, 'argv', ['tool.py'] + argv)
  module.main()
  return capsys.readouterr().out


def test_velocity_diagnosis_matches_jax_one_bin(orbax_dir, monkeypatch,
                                                capsys):
  argv = ['--checkpoint', str(orbax_dir), '--model', 'tiny', '--data',
          'synthetic', '--num', '2']
  want = _jax_main(load_jax_tool('tools/velocity_diagnosis.py'), argv,
                   monkeypatch, capsys)
  velocity_diagnosis.main(argv + ['--device', 'cpu'])
  got = capsys.readouterr().out
  assert got == want
  assert json.loads(got)['velocity_bins'] == 1


def _canned(ns, shift):
  """The reference's non-drum notes with velocities moved by `shift`
  (a different amount a note), as a transcription of the clip."""
  notes = [dataclasses.replace(n, velocity=int(np.clip(
      n.velocity + shift * (i % 5 - 2), 1, 127)))
      for i, n in enumerate(ns.notes) if not n.is_drum]
  return dataclasses.replace(ns, notes=notes)


def _canned_transcriber(sequences):
  """A Transcriber class that returns _canned(sequence) for each call."""

  class Canned:
    def __init__(self, *args, **kwargs):
      self.queue = iter(sequences)

    def __call__(self, audio):
      return _canned(next(self.queue), 9)
  return Canned


def test_velocity_diagnosis_matches_jax_127_bins(monkeypatch, capsys,
                                                 tmp_path):
  """The multi-bin branch (confusion, MAE): both tools' checkpoint loads
  and Transcribers replaced by canned transcriptions made from the same
  clips, so that the diagnosis itself is compared."""
  make_corpus.main(['--out', str(tmp_path), '--num', '1',
                    '--num_validation', '1', '--num_test', '3',
                    '--duration', '2.048', '--programs', '0,40',
                    '--max_instruments', '2', '--velocity_bins', '127',
                    '--no_ties'])
  jax_tool = load_jax_tool('tools/velocity_diagnosis.py')
  for module, data in ((jax_tool, jax_datasets),
                       (velocity_diagnosis, port_datasets)):
    sequences = [ex['sequence'] for ex in data.LocalPairsDataSource(
        str(tmp_path / 'test')).examples()]
    monkeypatch.setattr(module.transcribe_lib, 'Transcriber',
                        _canned_transcriber(sequences))
  monkeypatch.setattr(jax_tool.t5, 'init_params', lambda *a: (None, None))
  monkeypatch.setattr(jax_tool.ckpt_lib, 'restore_checkpoint',
                      lambda path, target: {'params': None})
  monkeypatch.setattr(velocity_diagnosis.ckpt_lib, 'load_params',
                      lambda path, model: (None, path))
  argv = ['--checkpoint', str(tmp_path), '--model', 'ismir2021', '--data',
          str(tmp_path / 'test'), '--num', '3']
  want = _jax_main(jax_tool, argv, monkeypatch, capsys)
  velocity_diagnosis.main(argv + ['--device', 'cpu'])
  got = capsys.readouterr().out
  assert got == want
  result = json.loads(got)
  assert result['velocity_bins'] == 127 and result['onset_matched_pairs']
  assert {'velocity_mae', 'confusion_rows_ref_cols_est',
          'confusion_diag_fraction'} <= set(result), result
