"""Materialize the polyphonic synthetic corpus: segment cache + eval splits
(port of tools/make_corpus.py; the same flags write the same bytes).

Builds the training segment cache (the reference's offline seqio cache
analog, tasks.py:150) from PolyphonicSynthDataSource, and writes held-out
validation/test splits as (wav, mid) pair directories readable by
LocalPairsDataSource — so `cli/train.py --cache_dir ... --eval_data ...`
runs the full flagship recipe end to end.  Host only: no device is used.

Usage:
  python -m mt3_tpu_torch.tools.make_corpus --out corpus --num 4096
  python -m mt3_tpu_torch.tools.make_corpus --out corpus_piano --num 3072 \
      --programs 0 --velocity_bins 127 --no_ties      # ismir2021 flavour
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import wave

import numpy as np

from mt3_tpu_torch.codec import vocabulary
from mt3_tpu_torch.core import midi_io
from mt3_tpu_torch.core.config import SpectrogramConfig, VocabularyConfig
from mt3_tpu_torch.data import pipeline
from mt3_tpu_torch.data.synth import PolyphonicSynthDataSource


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
  pcm = np.clip(samples, -1.0, 1.0)
  pcm = (pcm * 32767.0).astype('<i2')
  with wave.open(path, 'wb') as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(sample_rate)
    w.writeframes(pcm.tobytes())


def write_pairs_split(source: PolyphonicSynthDataSource, out_dir: str) -> None:
  os.makedirs(out_dir, exist_ok=True)
  for i in range(len(source)):
    ex = source.example(i)
    stem = os.path.join(out_dir, f'clip-{i:04d}')
    write_wav(stem + '.wav', ex['audio'], source.sample_rate)
    midi_io.note_sequence_to_midi_file(ex['sequence'], stem + '.mid')


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--out', required=True)
  parser.add_argument('--num', type=int, default=4096)
  parser.add_argument('--num_validation', type=int, default=24)
  parser.add_argument('--num_test', type=int, default=64)
  parser.add_argument('--duration', type=float, default=8.192)
  parser.add_argument('--seed', type=int, default=1000)
  parser.add_argument('--max_instruments', type=int, default=4)
  parser.add_argument('--drum_prob', type=float, default=0.5)
  parser.add_argument('--velocity_bins', type=int, default=1,
                      help='vocab config for target indexing (1 = mt3, '
                           '127 = ismir2021)')
  parser.add_argument('--programs', default=None,
                      help='comma-separated GM program pool (default: '
                           'the multi-family DEFAULT_PROGRAMS; use '
                           '"0" for the ismir2021 piano-only corpus)')
  parser.add_argument('--no_ties', action='store_true',
                      help='omit tie sections in cached targets '
                           '(ismir2021 flavor: USE_TIES=False, '
                           'gin/ismir2021.gin)')
  args = parser.parse_args(argv)

  spec_config = SpectrogramConfig()
  codec = vocabulary.build_codec(
      VocabularyConfig(num_velocity_bins=args.velocity_bins))

  common = dict(duration=args.duration, max_instruments=args.max_instruments,
                drum_prob=args.drum_prob,
                sample_rate=spec_config.sample_rate)
  if args.programs is not None:
    common['programs'] = tuple(
        int(p) for p in args.programs.split(','))
  train = PolyphonicSynthDataSource(
      num_examples=args.num, seed=args.seed, **common)
  validation = PolyphonicSynthDataSource(
      num_examples=args.num_validation, seed=args.seed + 9_000_000, **common)
  test = PolyphonicSynthDataSource(
      num_examples=args.num_test, seed=args.seed + 9_500_000, **common)

  cache_dir = os.path.join(args.out, 'cache')
  t0 = time.time()

  def progress(src):
    for i, ex in enumerate(src.examples()):
      if i and i % 256 == 0:
        rate = i / (time.time() - t0)
        print(f'  {i}/{len(src)} clips ({rate:.1f}/s, '
              f'eta {(len(src) - i) / rate / 60:.1f} min)', file=sys.stderr)
      yield ex

  n = pipeline.build_segment_cache(
      progress(train), spec_config, codec, cache_dir,
      include_ties=not args.no_ties)
  print(f'train cache: {n} segments in {time.time() - t0:.0f}s '
        f'-> {cache_dir}', file=sys.stderr)

  write_pairs_split(validation, os.path.join(args.out, 'validation'))
  write_pairs_split(test, os.path.join(args.out, 'test'))
  print(f'validation: {len(validation)} clips, test: {len(test)} clips',
        file=sys.stderr)


if __name__ == '__main__':
  main()
