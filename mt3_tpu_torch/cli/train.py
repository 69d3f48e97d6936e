"""CLI: train a model with the PyTorch port.

Usage:
  python -m mt3_tpu_torch.cli.train --model mt3 --data synthetic \
      --steps 100 --batch_size 64 --attention flash --bf16 \
      --checkpoint_dir ckpt/

Mirrors mt3_tpu/cli/train.py: dataset -> pipeline -> train step on one
device -> periodic checkpoints.  Runs on CUDA unless --device cpu is given.
The pipeline's raw audio frames become log-mel features on the device
(kernel A) on the prefetch thread, so the transfer overlaps the previous
step.  --gqa_kv_heads N trains grouped-query attention from scratch.
Flags of slices not ported yet (evaluation, warm starts, the segment
cache, TensorBoard logs, model partitions) are accepted and raise
NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from mt3_tpu_torch.core.config import CONFIG_FACTORIES

_NOT_PORTED = {
    'eval_period': 'evaluation during training (ROADMAP.md, modules to '
                   'port: evaluation)',
    'init_from': 'warm starts from orbax/T5X checkpoints (ROADMAP.md, '
                 'modules to port: checkpoint import)',
    'cache_dir': 'the offline segment cache (ROADMAP.md, modules to port: '
                 'training data sources)',
    'num_model_partitions': 'model partitions over a device mesh '
                            '(ROADMAP.md, modules to port: multi-device)',
    'log_dir': 'TensorBoard and metrics.jsonl logs (ROADMAP.md, modules to '
               'port: profiling and logs)',
}


def main(argv=None):
  parser = argparse.ArgumentParser(description='Train a transcription model')
  parser.add_argument('--model', default='tiny',
                      choices=sorted(CONFIG_FACTORIES))
  parser.add_argument('--data', default='synthetic',
                      help="'synthetic' (other sources are not ported yet)")
  parser.add_argument('--steps', type=int, default=None)
  parser.add_argument('--batch_size', type=int, default=None)
  parser.add_argument('--checkpoint_dir', default=None)
  parser.add_argument('--checkpoint_period', type=int, default=None)
  parser.add_argument('--resume', action='store_true',
                      help='resume from the latest checkpoint in '
                           'checkpoint_dir')
  parser.add_argument('--log_every', type=int, default=10)
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--remat', action='store_true',
                      help='rematerialize transformer layers')
  parser.add_argument('--attention', default=None, choices=['xla', 'flash'],
                      help="training attention impl override ('flash' "
                           'takes kernel C)')
  parser.add_argument('--dropout', type=float, default=None,
                      help='dropout rate override')
  parser.add_argument('--lr', type=float, default=None)
  parser.add_argument('--bf16', action='store_true',
                      help='bfloat16 activations')
  parser.add_argument('--max_examples_per_mix', type=int, default=None,
                      help='override the preset: mix 1..N random examples '
                           'per training example')
  parser.add_argument('--device', default=None,
                      help="torch device (default: cuda; 'cpu' to run on "
                           'the CPU)')
  parser.add_argument('--eval_period', type=int, default=0,
                      help='not ported yet')
  parser.add_argument('--init_from', default=None, help='not ported yet')
  parser.add_argument('--gqa_kv_heads', type=int, default=0,
                      help='grouped-query attention with N KV heads, '
                           'trained from scratch')
  parser.add_argument('--cache_dir', default=None, help='not ported yet')
  parser.add_argument('--num_model_partitions', type=int, default=1,
                      help='not ported yet')
  parser.add_argument('--log_dir', default=None, help='not ported yet')
  args = parser.parse_args(argv)

  for flag, item in _NOT_PORTED.items():
    value = getattr(args, flag)
    if value and not (flag == 'num_model_partitions' and value == 1):
      raise NotImplementedError(f'--{flag}: {item} is not ported yet')

  from mt3_tpu_torch.codec import vocabulary
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.data import datasets, pipeline
  from mt3_tpu_torch.device import resolve_device
  from mt3_tpu_torch.train import trainer as trainer_lib

  device = resolve_device(args.device)
  config = config_lib.CONFIG_FACTORIES[args.model]()
  model_overrides = {}
  if args.remat:
    model_overrides['remat'] = True
  if args.attention is not None:
    model_overrides['train_attention_impl'] = args.attention
  if args.dropout is not None:
    model_overrides['dropout_rate'] = args.dropout
  if args.bf16:
    model_overrides['dtype'] = 'bfloat16'
  if args.gqa_kv_heads:
    model_overrides['num_kv_heads'] = args.gqa_kv_heads
  if model_overrides:
    config = dataclasses.replace(
        config, model=dataclasses.replace(config.model, **model_overrides))
  if args.lr is not None:
    config = dataclasses.replace(
        config, run=dataclasses.replace(config.run, learning_rate=args.lr))
  run = config.run
  steps = args.steps if args.steps is not None else run.train_steps
  batch_size = args.batch_size or run.batch_size

  codec = vocabulary.build_codec(config.vocab)
  vocab = vocabulary.vocabulary_from_codec(codec)
  source = datasets.resolve_data_source(
      args.data, config.spectrogram, num_examples=8, seed=args.seed)
  print(f'dataset: {len(source)} examples', file=sys.stderr)

  pipe_cfg = pipeline.TrainPipelineConfig(
      inputs_length=run.inputs_length, targets_length=run.targets_length,
      batch_size=batch_size, onsets_only=run.onsets_only,
      include_ties=run.use_ties,
      program_granularity=run.program_granularity,
      max_examples_per_mix=(args.max_examples_per_mix
                            if args.max_examples_per_mix is not None
                            else run.max_examples_per_mix),
      seed=args.seed)
  raw_batches = pipeline.train_batches(
      source.examples(), config.spectrogram, codec, vocab, pipe_cfg)

  tr = trainer_lib.Trainer(model_config=config.model, run_config=run,
                           seed=args.seed, device=device)
  start_step = 0
  if args.resume and args.checkpoint_dir:
    from mt3_tpu_torch.train import checkpoint as ckpt_lib
    path = ckpt_lib.latest_checkpoint(args.checkpoint_dir)
    if path is None:
      print(f'no checkpoint to resume in {args.checkpoint_dir}; starting '
            'fresh', file=sys.stderr)
    else:
      start_step = tr.restore(path)
      print(f'resumed from step {start_step}', file=sys.stderr)

  batches = pipeline.prefetch(
      raw_batches, transform=lambda b: trainer_lib.model_batch(
          b, config.spectrogram, device))

  ckpt_period = args.checkpoint_period or run.checkpoint_period
  last_saved_step = start_step
  start = time.time()
  for step in range(start_step, steps):
    metrics = tr.step(next(batches))
    if step % args.log_every == 0 or step == steps - 1:
      elapsed = time.time() - start
      print(f'step {step}: loss={float(metrics["loss"]):.4f} '
            f'acc={float(metrics["accuracy"]):.3f} '
            f'lr={float(metrics["learning_rate"]):.2e} '
            f'({(step - start_step + 1) / max(elapsed, 1e-9):.2f} '
            f'steps/s)', file=sys.stderr)
    if args.checkpoint_dir and (step + 1) % ckpt_period == 0:
      print(f'saving checkpoint: {tr.save(args.checkpoint_dir)}',
            file=sys.stderr)
      last_saved_step = step + 1
  if args.checkpoint_dir and last_saved_step != max(steps, start_step):
    print(f'saved final checkpoint: {tr.save(args.checkpoint_dir)}',
          file=sys.stderr)


if __name__ == '__main__':
  main()
