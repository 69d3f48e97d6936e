"""CLI: train a model with the PyTorch port.

Usage:
  python -m mt3_tpu_torch.cli.train --model mt3 --data synthetic \
      --steps 100 --batch_size 64 --attention flash --bf16 \
      --checkpoint_dir ckpt/

Mirrors mt3_tpu/cli/train.py: dataset -> pipeline -> train step on one
device -> periodic checkpoints and evaluation.  Runs on CUDA unless
--device cpu is given.  The pipeline's raw audio frames become log-mel
features on the device (kernel A) on the prefetch thread, so the transfer
overlaps the previous step.  --gqa_kv_heads N trains grouped-query
attention from scratch, or, with --init_from, finetunes MHA weights
mean-pooled to N K/V heads.  --eval_period N transcribes and scores a
held-out set every N steps.  Flags of slices not ported yet (the segment
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
                      help='run transcription eval every N steps')
  parser.add_argument('--eval_data', default=None,
                      help="held-out eval data ('synthetic' as yet); "
                           'defaults to a held-out synthetic split')
  parser.add_argument('--eval_examples', type=int, default=4)
  parser.add_argument('--init_from', default=None,
                      help='warm-start parameters from a checkpoint '
                           'directory/path with a fresh optimizer (the '
                           'reference finetune recipe)')
  parser.add_argument('--gqa_kv_heads', type=int, default=0,
                      help='grouped-query attention with N KV heads: '
                           'trained from scratch, or with --init_from the '
                           '(MHA) checkpoint converted before finetuning')
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
  if args.init_from:
    from mt3_tpu_torch import params as params_lib
    from mt3_tpu_torch.train import checkpoint as ckpt_lib
    load_config = dataclasses.replace(config.model, num_kv_heads=None)
    params, path = ckpt_lib.load_params(args.init_from, load_config)
    if args.gqa_kv_heads:
      print(f'converting to GQA: {config.model.num_heads} -> '
            f'{args.gqa_kv_heads} KV heads', file=sys.stderr)
      # The recovery finetune follows at once, so the unfinetuned warm
      # start is legitimate here.
      params = params_lib.convert_mha_to_gqa(
          params, config.model.num_heads, config.model.head_dim,
          args.gqa_kv_heads, allow_unfinetuned=True)
    tr.load_params(params)
    print(f'warm-started params from {path}', file=sys.stderr)
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

  # Held-out eval split (reference gin/train.gin:89-97: seqio.Evaluator
  # every eval_period steps over the eval tasks).
  if args.eval_data:
    eval_source = datasets.resolve_data_source(
        args.eval_data, config.spectrogram, num_examples=args.eval_examples,
        seed=args.seed + 1_000_000)
  else:
    eval_source = datasets.SyntheticDataSource(
        num_examples=args.eval_examples, duration=4.0,
        sample_rate=config.spectrogram.sample_rate, seed=args.seed + 1)

  def run_eval(step):
    from mt3_tpu_torch.eval import evaluator
    from mt3_tpu_torch.infer import transcribe as transcribe_lib
    transcriber = transcribe_lib.Transcriber(config, tr.state.params,
                                             device=device)
    eval_examples = list(eval_source.examples())[:args.eval_examples]
    scores = evaluator.evaluate_dataset(eval_examples, transcriber)
    print(f'eval@{step}: onset F1 = {scores.get("Onset F1", 0):.4f} '
          f'onset+offset F1 = '
          f'{scores.get("Onset + offset F1", 0):.4f}', file=sys.stderr)
    print(evaluator.write_metrics(scores, step=step), file=sys.stderr)

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
    if args.eval_period and (step + 1) % args.eval_period == 0:
      run_eval(step + 1)
  if args.checkpoint_dir and last_saved_step != max(steps, start_step):
    print(f'saved final checkpoint: {tr.save(args.checkpoint_dir)}',
          file=sys.stderr)


if __name__ == '__main__':
  main()
