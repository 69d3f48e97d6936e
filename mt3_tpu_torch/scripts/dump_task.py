"""Debug tool: print examples from a data pipeline (copy of mt3_tpu/scripts/dump_task.py).

Rebuild of mt3/scripts/dump_task.py (the seqio task
debugger): materializes training examples from a data source through the
full preprocessing chain and prints their shapes plus decoded targets.
"""

from __future__ import annotations

import argparse
import sys


from mt3_tpu_torch.core.config import CONFIG_FACTORIES


def main(argv=None):
  parser = argparse.ArgumentParser(description='Dump pipeline examples')
  parser.add_argument('--model', default='mt3',
                      choices=sorted(CONFIG_FACTORIES))
  parser.add_argument('--data', default='synthetic',
                      help="'synthetic', a directory of (wav, mid) pairs, "
                           'or reference-schema .tfrecord file(s)')
  parser.add_argument('--dataset', default='maestrov3',
                      help='corpus schema for .tfrecord inputs '
                           '(see datasets.ALL_DATASET_CONFIGS)')
  parser.add_argument('--num_examples', type=int, default=2)
  parser.add_argument('--decode_targets', action='store_true',
                      help='print decoded event names for targets')
  args = parser.parse_args(argv)

  from mt3_tpu_torch.codec import vocabulary
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.data import datasets, pipeline

  config = config_lib.CONFIG_FACTORIES[args.model]()
  codec = vocabulary.build_codec(config.vocab)
  vocab = vocabulary.vocabulary_from_codec(codec)

  source = datasets.resolve_data_source(
      args.data, config.spectrogram, dataset=args.dataset,
      is_training=True, num_examples=args.num_examples)

  pipe_cfg = pipeline.TrainPipelineConfig(
      inputs_length=config.run.inputs_length,
      targets_length=config.run.targets_length,
      batch_size=1,
      onsets_only=config.run.onsets_only,
      include_ties=config.run.use_ties,
      program_granularity=config.run.program_granularity)
  batches = pipeline.train_batches(source.examples(), config.spectrogram,
                                   codec, vocab, pipe_cfg)

  for i in range(args.num_examples):
    batch = next(batches)
    targets = batch['decoder_target_tokens'][0]
    n = int((targets > 0).sum())
    print(f'=== example {i} ===')
    for key, value in batch.items():
      print(f'  {key}: shape={value.shape} dtype={value.dtype}')
    print(f'  targets ({n} non-pad): {targets[:n].tolist()}')
    if args.decode_targets:
      decoded = vocab.decode(targets[:n].tolist())
      names = []
      for idx in decoded:
        if idx < 0:
          names.append('EOS' if idx == -1 else 'INVALID')
          continue
        event = codec.decode_event_index(idx)
        names.append(f'{event.type}:{event.value}')
      print('  decoded:', ' '.join(names), file=sys.stdout)


if __name__ == '__main__':
  main()
