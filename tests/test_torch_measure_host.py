"""The port's host benches against the JAX package's, on the CPU.

mt3_tpu_torch.tools.postprocess_bench prints the counts of
tools/postprocess_bench.py (clips, segments, audio seconds, MIDI bytes) on
the same corpus, and mt3_tpu_torch.tools.mixing_host_bench draws the same
first mixed batch (--mix 8), bit for bit, from the same segment cache as
tools/mixing_host_bench.py.  The JAX tools are loaded from their files;
nothing in them is edited.
"""

import re
import sys

import numpy as np
import pytest

from mt3_tpu.data import pipeline as jax_pipeline
from mt3_tpu_torch.data import pipeline
from mt3_tpu_torch.tools import make_corpus, mixing_host_bench
from mt3_tpu_torch.tools import postprocess_bench
from tests.test_torch_quality_gates import load_jax_tool


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
  root = tmp_path_factory.mktemp('corpus')
  make_corpus.main(['--out', str(root), '--num', '3', '--num_validation',
                    '1', '--num_test', '3', '--duration', '4.096'])
  return root


LINE = re.compile(r'(\d+) clips, (\d+) segments, (\d+) audio-s: \d+ ms -> '
                  r'\d+ audio-s/s host postprocess \([0-9.]+ ms/segment, '
                  r'(\d+) MIDI bytes\)')


def test_postprocess_bench_prints_the_jax_tools_counts(corpus, monkeypatch,
                                                       capsys):
  argv = ['--audio', str(corpus / 'test'), '--clips', '3', '--reps', '1']
  monkeypatch.setattr(sys, 'argv', ['postprocess_bench.py'] + argv)
  load_jax_tool('tools/postprocess_bench.py').main()
  want = LINE.search(capsys.readouterr().out)
  postprocess_bench.main(argv)
  got = LINE.search(capsys.readouterr().out)
  assert want and got
  assert got.groups() == want.groups()
  assert int(got.group(1)) == 3 and int(got.group(4)) > 0


def _recording(module, seen):
  """module.train_batches_from_cache, recording the batches it yields."""
  make = module.train_batches_from_cache

  def batches(*args, **kwargs):
    for batch in make(*args, **kwargs):
      seen.append(batch)
      yield batch
  return batches


@pytest.mark.parametrize('preload', [True, False])
def test_mixing_host_bench_draws_the_jax_tools_first_batch(
    corpus, monkeypatch, capsys, preload):
  argv = ['--cache', str(corpus / 'cache'), '--batch', '4', '--mix', '8',
          '--batches', '1'] + (['--preload'] if preload else [])
  want, got = [], []
  monkeypatch.setattr(jax_pipeline, 'train_batches_from_cache',
                      _recording(jax_pipeline, want))
  monkeypatch.setattr(pipeline, 'train_batches_from_cache',
                      _recording(pipeline, got))
  monkeypatch.setattr(sys, 'argv', ['mixing_host_bench.py'] + argv)
  load_jax_tool('tools/mixing_host_bench.py').main()
  jax_line = capsys.readouterr().out
  mixing_host_bench.main(argv)
  line = capsys.readouterr().out
  assert len(want) == len(got) == 2
  assert sorted(got[0]) == sorted(want[0])
  for key in want[0]:
    assert got[0][key].dtype == want[0][key].dtype, key
    np.testing.assert_array_equal(got[0][key], want[0][key], err_msg=key)
  form = re.compile(rf'mix<=8 batch=4 preload={preload}: [0-9.]+ '
                    r'batches/s = \d+ examples/s \(\d+ ms/batch\)')
  assert form.fullmatch(line.strip()) and form.fullmatch(jax_line.strip())
