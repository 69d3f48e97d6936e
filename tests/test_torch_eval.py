"""The evaluation path of the PyTorch port against mt3_tpu.

* The host copies (eval/transcription, eval/metrics, eval/summaries,
  infer/writer) equal the JAX package's modules with `mt3_tpu.` imports
  rewritten to `mt3_tpu_torch.` and reference paths shortened.
* evaluate_dataset with JAX's parameters carried across gives JAX's
  scores on the same synthetic examples, greedy and with beam search
  (the tokens are identical, so every score is equal).
* cli.evaluate on the CPU writes its JSON line and JSON lines; the train
  CLI's --eval_period scores a held-out synthetic split.
"""

import inspect
import json
import re

import jax
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.data import datasets as jax_datasets
from mt3_tpu.eval import evaluator as jax_evaluator
from mt3_tpu.eval import metrics as jax_metrics
from mt3_tpu.eval import summaries as jax_summaries
from mt3_tpu.eval import transcription as jax_transcription
from mt3_tpu.infer import transcribe as jax_transcribe
from mt3_tpu.infer import writer as jax_writer
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.data import datasets
from mt3_tpu_torch.eval import evaluator, metrics, summaries, transcription
from mt3_tpu_torch.infer import transcribe, writer
from mt3_tpu_torch.train import trainer

torch.set_num_threads(2)

_REFERENCE_CHECKOUT = re.compile(r'/[^\s:()]*/reference/mt3/')

COPIES = ((transcription, jax_transcription), (metrics, jax_metrics),
          (summaries, jax_summaries), (writer, jax_writer))


def _rewritten(source):
  return _REFERENCE_CHECKOUT.sub(
      'mt3/', source.replace('mt3_tpu.', 'mt3_tpu_torch.'))


@pytest.mark.parametrize('ours,theirs', COPIES,
                         ids=[m.__name__ for m, _ in COPIES])
def test_copied_modules_are_pinned(ours, theirs):
  assert inspect.getsource(ours) == _rewritten(inspect.getsource(theirs))


def test_write_metrics_is_pinned(tmp_path):
  assert inspect.getsource(evaluator.write_metrics) == inspect.getsource(
      jax_evaluator.write_metrics)
  line = evaluator.write_metrics({'Onset F1': 0.5}, str(tmp_path / 'm'),
                                 step=3)
  assert json.loads(line)['step'] == 3
  assert (tmp_path / 'm').read_text() == line + '\n'


@pytest.fixture(scope='module')
def models():
  jax_cfg = jax_config.tiny_config()
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(0), jax_cfg.model)
  numpy_params = jax.tree_util.tree_map(np.array, jax_params)
  # A larger EOS column: segments end at different lengths, so each
  # transcription holds a few notes and errors.
  numpy_params['decoder']['logits'][:, 1] *= 1.5
  return (jax_cfg, numpy_params, torch_config.tiny_config(),
          params_lib.from_numpy_tree(numpy_params))


@pytest.mark.parametrize('num_beams', (0, 2))
def test_evaluate_dataset_matches_jax(models, num_beams):
  jax_cfg, numpy_params, torch_cfg, torch_params = models
  examples = list(datasets.SyntheticDataSource(
      num_examples=2, duration=1.0, seed=5).examples())
  jax_examples = list(jax_datasets.SyntheticDataSource(
      num_examples=2, duration=1.0, seed=5).examples())
  want = jax_evaluator.evaluate_dataset(
      jax_examples, jax_transcribe.Transcriber(jax_cfg, numpy_params,
                                               num_beams=num_beams))
  got = evaluator.evaluate_dataset(
      examples, transcribe.Transcriber(torch_cfg, torch_params,
                                       num_beams=num_beams, device='cpu'))
  assert sorted(got) == sorted(want)
  assert got['Invalid events'] + got['Dropped events'] > 0
  for key in want:
    assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-9), key


def test_evaluate_cli_writes_json_and_jsonl(tmp_path, capsys):
  from mt3_tpu_torch.cli import evaluate as cli
  tiny = torch_config.tiny_config()
  tr = trainer.Trainer(tiny.model, tiny.run, device='cpu')
  tr.save(str(tmp_path / 'ckpt'))
  cli.main(['--model', 'tiny', '--data', 'synthetic', '--num_examples', '1',
            '--checkpoint', str(tmp_path / 'ckpt'), '--device', 'cpu',
            '--output', str(tmp_path / 'm.json'),
            '--write_jsonl', str(tmp_path / 'notes.jsonl')])
  out = capsys.readouterr()
  assert 'checkpoint_0.pt' in out.err
  record = json.loads((tmp_path / 'm.json').read_text())
  assert json.loads(out.out.strip().splitlines()[-1]) == record
  assert 'Onset F1' in record and 'Frame F1' in record
  lines = (tmp_path / 'notes.jsonl').read_text().splitlines()
  assert len(lines) == 1 and json.loads(lines[0])['id'] == 0
  assert isinstance(json.loads(lines[0])['est_notes'], list)
  # A TFRecord spec resolves as JAX's does; a missing file fails to open.
  with pytest.raises(IOError, match='cannot open'):
    cli.main(['--model', 'tiny', '--data', str(tmp_path / 'none.tfrecord'),
              '--device', 'cpu'])


def test_train_cli_eval_period(capsys):
  from mt3_tpu_torch.cli import train as cli
  cli.main(['--model', 'tiny', '--steps', '2', '--batch_size', '2',
            '--device', 'cpu', '--eval_period', '1', '--eval_examples', '1'])
  err = capsys.readouterr().err
  assert 'eval@1: onset F1 = ' in err and 'eval@2: onset F1 = ' in err
  records = [json.loads(line) for line in err.splitlines()
             if line.startswith('{')]
  assert [r['step'] for r in records] == [1, 2]
  assert all('Onset + offset F1' in r for r in records)


@pytest.mark.parametrize('eval_data,want_seed', ((None, 4),
                                                  ('synthetic', 1_000_003)))
def test_train_cli_eval_source_is_held_out(monkeypatch, eval_data,
                                           want_seed):
  """The eval split is SyntheticDataSource(seed + 1) without --eval_data
  and --eval_data's source at seed + 1e6 with it, as in the JAX CLI:
  other clips than the training ones (seed 3)."""
  from mt3_tpu_torch.cli import train as cli
  made = []

  class Recording(datasets.SyntheticDataSource):
    def __init__(self, **kwargs):
      made.append(kwargs)
      super().__init__(**kwargs)

  monkeypatch.setattr(datasets, 'SyntheticDataSource', Recording)
  cli.main(['--model', 'tiny', '--steps', '1', '--batch_size', '2',
            '--device', 'cpu', '--seed', '3', '--eval_period', '1',
            '--eval_examples', '1']
           + (['--eval_data', eval_data] if eval_data else []))
  assert [m['seed'] for m in made] == [3, want_seed]
  assert made[1]['num_examples'] == 1 and made[1]['duration'] == 4.0


def _write_pairs(directory):
  import wave
  from mt3_tpu_torch.core import midi_io
  from mt3_tpu_torch.data import synth
  directory.mkdir()
  for i in range(2):
    ns = synth.compose_example(9_001_000 + i, 1.5, max_instruments=2)
    audio = synth.render_note_sequence(ns, 1.5, seed=i)
    with wave.open(str(directory / f'clip-{i}.wav'), 'wb') as w:
      w.setnchannels(1)
      w.setsampwidth(2)
      w.setframerate(16000)
      w.writeframes((np.clip(audio, -1, 1) * 32767).astype('<i2').tobytes())
    midi_io.note_sequence_to_midi_file(ns, str(directory / f'clip-{i}.mid'))
  return str(directory), 'maestrov3'


def _write_guitarset(directory):
  import io
  import wave
  from mt3_tpu_torch.core import noteseq_proto
  from mt3_tpu_torch.core.note_sequence import Note, NoteSequence
  from mt3_tpu_torch.data import tfrecord
  directory.mkdir()
  ns = NoteSequence(total_time=1.5)
  ns.notes = [Note(pitch=52, velocity=95, start_time=0.1, end_time=0.9)]
  buf = io.BytesIO()
  with wave.open(buf, 'wb') as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(16000)
    w.writeframes((np.sin(np.arange(24000) * 0.05) * 8000).astype(
        '<i2').tobytes())
  path = str(directory / 'gset.tfrecord')
  tfrecord.write_records(path, [tfrecord.make_example({
      'audio': buf.getvalue(),
      'sequence': noteseq_proto.notesequence_to_bytes(ns),
      'id': b'gset-1'})])
  return path, 'guitarset'


@pytest.mark.parametrize('make', (_write_pairs, _write_guitarset),
                         ids=('wav_midi_directory', 'tfrecord_dataset'))
def test_evaluate_cli_reads_every_source_as_jax(tmp_path, capsys,
                                                monkeypatch, make):
  """--data and --dataset reach resolve_data_source as in the JAX CLI: the
  evaluator sees JAX's examples of the same spec, bit for bit."""
  from mt3_tpu_torch.cli import evaluate as cli
  spec, dataset = make(tmp_path / 'data')
  seen = []
  real = evaluator.evaluate_dataset

  def recording(examples, transcriber, track_specs=None):
    seen.extend(examples)
    return real(examples, transcriber, track_specs)

  monkeypatch.setattr(evaluator, 'evaluate_dataset', recording)
  cli.main(['--model', 'tiny', '--data', spec, '--dataset', dataset,
            '--device', 'cpu', '--output', str(tmp_path / 'm.json')])
  record = json.loads((tmp_path / 'm.json').read_text())
  assert 'Onset F1' in record
  want = list(jax_datasets.resolve_data_source(
      spec, jax_config.SpectrogramConfig(), dataset=dataset).examples())
  assert len(seen) == len(want) > 0
  for a, b in zip(seen, want):
    assert a['sequence'].id == b['sequence'].id
    assert ([(n.pitch, n.program, n.start_time, n.end_time)
             for n in a['sequence'].notes]
            == [(n.pitch, n.program, n.start_time, n.end_time)
                for n in b['sequence'].notes])
    np.testing.assert_array_equal(a['audio'], b['audio'])
  if dataset == 'guitarset':
    assert {n.program for n in seen[0]['sequence'].notes} == {24}
