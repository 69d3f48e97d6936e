"""CLI: train a model with the PyTorch port.

Usage (the JAX package's flagship recipe, tools/run_flagship.sh):
  python -m mt3_tpu_torch.cli.train --model mt3 \
      --data polysynth:16384:1000 --cache_dir corpus/cache --preload_cache \
      --eval_data corpus/validation --eval_examples 24 --eval_period 1000 \
      --batch_size 256 --remat --attention flash --bf16 \
      --checkpoint_dir ckpt/ --checkpoint_period 1000 --log_dir logs/ \
      --resume --exit_rss_gb 70

Mirrors mt3_tpu/cli/train.py: dataset -> [segment cache] -> pipeline ->
train step on one device -> periodic asynchronous checkpoints, evaluation
and logs.  Runs on CUDA unless --device cpu is given.  The pipeline's raw
audio frames become log-mel features on the device (kernel A) on the
prefetch thread, so the transfer overlaps the previous step.  --data takes
'synthetic', 'polysynth[:N[:seed]]', reference-schema .tfrecord files or
shard globs (with --dataset naming the corpus) and directories of wav+MIDI
pairs.  --cache_dir builds the offline segment cache when it holds no shard
and then trains from it (read through data/tfrecord.py; the reader in use,
native or Python, is printed on stderr).  --log_dir writes a TensorBoard
event file and metrics.jsonl.  --exit_rss_gb checkpoints and exits with
code 75 once the host's resident memory passes the limit.  --gqa_kv_heads N
trains grouped-query attention from scratch, or, with --init_from,
finetunes MHA weights mean-pooled to N K/V heads.  At exit the CLI prints
how long the step loop waited on the prefetch queue, and the kernel
launches of the run (ops.launch_counts) with, on a card, its peak device
memory.

Several processes (torchrun, one per device) train on a ('data', 'model')
mesh, as the JAX CLI builds one whenever it sees more than one device:
  torchrun --nproc_per_node 8 -m mt3_tpu_torch.cli.train --model mt3 \
      --num_model_partitions 2 ...
--backend gloo runs several ranks on one card (NCCL refuses that), or on
CPUs; --coordinator_address replaces torchrun's MASTER_ADDR/MASTER_PORT
(e.g. file:///tmp/rendezvous).  Every rank draws the same global batch
from the same seed and stages its own rows; evaluation runs through
Transcriber(mesh=); rank 0 logs and writes the checkpoints.  The JAX CLI's
--compile_cache (XLA's persistent compile cache) has no counterpart here
and is left out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from mt3_tpu_torch.core.config import CONFIG_FACTORIES

EXIT_RELAUNCH = 75


def _rss_gb() -> float:
  with open('/proc/self/status') as f:
    for line in f:
      if line.startswith('VmRSS'):
        return int(line.split()[1]) / 1024 / 1024
  return 0.0


def build_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description='Train a transcription model')
  parser.add_argument('--model', default='tiny',
                      choices=sorted(CONFIG_FACTORIES))
  parser.add_argument('--data', default='synthetic',
                      help="'synthetic', 'polysynth[:N[:seed]]', a directory "
                           'of wav+midi pairs, or reference-schema '
                           '.tfrecord file(s) / shard globs')
  parser.add_argument('--dataset', default='maestrov3',
                      help='corpus schema for .tfrecord inputs (see '
                           'datasets.ALL_DATASET_CONFIGS)')
  parser.add_argument('--steps', type=int, default=None)
  parser.add_argument('--batch_size', type=int, default=None)
  parser.add_argument('--checkpoint_dir', default=None)
  parser.add_argument('--checkpoint_period', type=int, default=None)
  parser.add_argument('--resume', action='store_true',
                      help='resume from the latest checkpoint in '
                           'checkpoint_dir')
  parser.add_argument('--init_from', default=None,
                      help='warm-start parameters from a checkpoint '
                           'directory/path with a fresh optimizer (the '
                           'reference finetune recipe)')
  parser.add_argument('--gqa_kv_heads', type=int, default=0,
                      help='grouped-query attention with N KV heads: '
                           'trained from scratch, or with --init_from the '
                           '(MHA) checkpoint converted before finetuning')
  parser.add_argument('--eval_period', type=int, default=0,
                      help='run transcription eval every N steps')
  parser.add_argument('--eval_data', default=None,
                      help='held-out eval data (same formats as --data); '
                           'defaults to a held-out split of --data')
  parser.add_argument('--eval_examples', type=int, default=4)
  parser.add_argument('--cache_dir', default=None,
                      help='offline tokenization cache directory; built on '
                           'first use if it holds no shard')
  parser.add_argument('--preload_cache', action='store_true',
                      help='decode the segment cache into RAM once '
                           '(recommended at large batch sizes)')
  parser.add_argument('--log_dir', default=None,
                      help='TensorBoard event + metrics.jsonl directory')
  parser.add_argument('--num_model_partitions', type=int, default=1,
                      help="model partitions of the ('data', 'model') mesh "
                           'over WORLD_SIZE processes')
  parser.add_argument('--backend', default=None, choices=['nccl', 'gloo'],
                      help='torch.distributed backend for several processes '
                           '(default: nccl on CUDA, gloo on the CPU; gloo '
                           'for several ranks on one card)')
  parser.add_argument('--coordinator_address', default=None,
                      help='rendezvous of several processes: host:port or '
                           "a tcp:// or file:// URL (default: torchrun's "
                           'environment)')
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
  parser.add_argument('--exit_rss_gb', type=float, default=0,
                      help='if >0: when host RSS exceeds this many GB, '
                           'checkpoint and exit with code 75 so a wrapper '
                           'can relaunch with --resume')
  parser.add_argument('--device', default=None,
                      help="torch device (default: cuda; 'cpu' to run on "
                           'the CPU)')
  return parser


def main(argv=None):
  args = build_parser().parse_args(argv)

  import torch

  from mt3_tpu_torch import ops
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.codec import vocabulary
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.data import datasets, pipeline, tfrecord
  from mt3_tpu_torch.device import resolve_device
  from mt3_tpu_torch.parallel import multihost, partitioning
  from mt3_tpu_torch.train import checkpoint as ckpt_lib
  from mt3_tpu_torch.train import trainer as trainer_lib

  mesh = None
  if (int(os.environ.get('WORLD_SIZE', '1')) > 1
      or args.num_model_partitions > 1):
    backend = args.backend or (
        'gloo' if resolve_device(args.device).type == 'cpu' else 'nccl')
    multihost.initialize(args.coordinator_address, backend=backend)
    mesh = partitioning.make_mesh(args.num_model_partitions,
                                  device=args.device)
    device = mesh.device
  else:
    device = resolve_device(args.device)
  chief = mesh is None or mesh.is_chief

  def say(message):
    if chief:
      print(message, file=sys.stderr)

  if mesh is not None:
    say(f'mesh: data {mesh.data}, model {mesh.model} ({device})')
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

  if args.cache_dir or '.tfrecord' in args.data:
    say(f'TFRecord reader: {tfrecord.native_status()}')
  source = datasets.resolve_data_source(
      args.data, config.spectrogram, dataset=args.dataset,
      is_training=True, num_examples=8, seed=args.seed)
  say(f'dataset: {len(source)} examples')

  pipe_cfg = pipeline.TrainPipelineConfig(
      inputs_length=run.inputs_length, targets_length=run.targets_length,
      batch_size=batch_size, onsets_only=run.onsets_only,
      include_ties=run.use_ties,
      program_granularity=run.program_granularity,
      max_examples_per_mix=(args.max_examples_per_mix
                            if args.max_examples_per_mix is not None
                            else run.max_examples_per_mix),
      seed=args.seed)
  if args.cache_dir:
    # Rank 0 builds a missing cache; the others read it once it is built.
    if chief and not any(f.startswith('cache-') for f in (
        os.listdir(args.cache_dir) if os.path.isdir(args.cache_dir)
        else ())):
      start = time.perf_counter()
      n = pipeline.build_segment_cache(
          source.examples(), config.spectrogram, codec, args.cache_dir,
          onsets_only=run.onsets_only, include_ties=run.use_ties)
      say(f'built segment cache: {n} segments -> {args.cache_dir} in '
          f'{time.perf_counter() - start:.2f}s')
    partitioning.barrier(mesh)
    raw_batches = pipeline.train_batches_from_cache(
        args.cache_dir, codec, vocab, pipe_cfg,
        preload=args.preload_cache)
  else:
    raw_batches = pipeline.train_batches(
        source.examples(), config.spectrogram, codec, vocab, pipe_cfg)

  tr = trainer_lib.Trainer(model_config=config.model, run_config=run,
                           mesh=mesh, seed=args.seed, device=device)
  start_step = 0
  if args.init_from:
    load_config = dataclasses.replace(config.model, num_kv_heads=None)
    params, path = ckpt_lib.load_params(args.init_from, load_config)
    if args.gqa_kv_heads:
      say(f'converting to GQA: {config.model.num_heads} -> '
          f'{args.gqa_kv_heads} KV heads')
      # The recovery finetune follows at once, so the unfinetuned warm
      # start is legitimate here.
      params = params_lib.convert_mha_to_gqa(
          params, config.model.num_heads, config.model.head_dim,
          args.gqa_kv_heads, allow_unfinetuned=True)
    tr.load_params(params)
    say(f'warm-started params from {path}')
  if args.resume and args.checkpoint_dir:
    path = ckpt_lib.latest_checkpoint(args.checkpoint_dir)
    if path is None:
      say(f'no checkpoint to resume in {args.checkpoint_dir}; starting '
          'fresh')
    else:
      start_step = tr.restore(path)
      say(f'resumed from step {start_step}')

  # Staged on the device by a prefetch thread, stopped and drained at exit.
  batches = trainer_lib.StagedBatches(raw_batches, config.spectrogram,
                                      device, mesh)

  # Held-out eval split (reference gin/train.gin:89-97: seqio.Evaluator
  # every eval_period steps over the eval tasks, logging the full metric
  # family to TensorBoard + JSON).
  if args.eval_data:
    # Offset the default seed so 'polysynth[:N]' eval specs (without an
    # explicit seed) never collide with the training clips.
    eval_source = datasets.resolve_data_source(
        args.eval_data, config.spectrogram, dataset=args.dataset,
        num_examples=args.eval_examples, seed=args.seed + 1_000_000)
  elif args.data == 'synthetic':
    eval_source = datasets.SyntheticDataSource(
        num_examples=args.eval_examples, duration=4.0,
        sample_rate=config.spectrogram.sample_rate, seed=args.seed + 1)
  elif args.data.startswith('polysynth'):
    from mt3_tpu_torch.data.synth import PolyphonicSynthDataSource
    eval_source = PolyphonicSynthDataSource(
        num_examples=args.eval_examples, seed=args.seed + 1_000_000,
        max_instruments=4,
        sample_rate=config.spectrogram.sample_rate)
  else:
    eval_source = source

  tb_writer = None
  metrics_path = None
  if args.log_dir and chief:
    from mt3_tpu_torch.utils import tensorboard as tb_lib
    os.makedirs(args.log_dir, exist_ok=True)
    tb_writer = tb_lib.SummaryWriter(args.log_dir)
    metrics_path = os.path.join(args.log_dir, 'metrics.jsonl')

  def run_eval(step):
    from mt3_tpu_torch.eval import evaluator
    from mt3_tpu_torch.infer import transcribe as transcribe_lib
    if mesh is None:
      transcriber = transcribe_lib.Transcriber(config, tr.state.params,
                                               device=device)
    else:
      transcriber = transcribe_lib.Transcriber(
          config, tr.full_params(), mesh=mesh,
          params_axes=params_lib.param_axes(config.model))
    eval_examples = list(eval_source.examples())[:args.eval_examples]
    scores = evaluator.evaluate_dataset(eval_examples, transcriber)
    say(f'eval@{step}: onset F1 = {scores.get("Onset F1", 0):.4f} '
        f'onset+offset F1 = {scores.get("Onset + offset F1", 0):.4f}')
    if chief:
      if tb_writer is not None:
        tb_writer.add_scalars(
            {f'eval/{k}': float(v) for k, v in scores.items()}, step)
      say(evaluator.write_metrics(scores, metrics_path, step=step))

  ckpt_period = args.checkpoint_period or run.checkpoint_period
  last_saved_step = start_step
  waited = eval_seconds = 0.0
  start = time.time()
  for step in range(start_step, steps):
    wait_start = time.perf_counter()
    batch = next(batches)
    waited += time.perf_counter() - wait_start
    metrics = tr.step(batch)
    if step % args.log_every == 0 or step == steps - 1:
      elapsed = time.time() - start
      say(f'step {step}: loss={float(metrics["loss"]):.4f} '
          f'acc={float(metrics["accuracy"]):.3f} '
          f'lr={float(metrics["learning_rate"]):.2e} '
          f'({(step - start_step + 1) / max(elapsed, 1e-9):.2f} '
          f'steps/s)')
      if tb_writer is not None:
        tb_writer.add_scalars(
            {f'train/{k}': float(v) for k, v in metrics.items()}, step)
    if args.checkpoint_dir and (step + 1) % ckpt_period == 0:
      # Async: the write overlaps subsequent steps (finalized at exit).
      say(f'saving checkpoint: '
          f'{tr.save(args.checkpoint_dir, asynchronous=True)}')
      last_saved_step = step + 1
    if args.eval_period and (step + 1) % args.eval_period == 0:
      eval_start = time.perf_counter()
      run_eval(step + 1)
      eval_seconds += time.perf_counter() - eval_start
    # Every rank leaves together: one over the limit stops them all.
    if (args.exit_rss_gb and step % args.log_every == 0
        and partitioning.any_rank(_rss_gb() > args.exit_rss_gb, mesh)):
      say(f'RSS {_rss_gb():.1f} GB on a rank > --exit_rss_gb '
          f'{args.exit_rss_gb}; checkpointing and exiting '
          f'{EXIT_RELAUNCH} for relaunch')
      batches.close()
      if args.checkpoint_dir:
        tr.finalize_saves()
        say(f'saved restart checkpoint: {tr.save(args.checkpoint_dir)}')
      sys.exit(EXIT_RELAUNCH)
  loop_seconds = time.time() - start - eval_seconds
  batches.close()
  ran = max(steps - start_step, 0)
  if ran:
    say(f'data: {batches.staged} batches staged for {ran} steps; the step '
        f'loop waited {1e3 * waited / ran:.1f} ms a step on the prefetch '
        f'queue of {1e3 * loop_seconds / ran:.1f} ms a step (evaluation, '
        f'{eval_seconds:.1f}s, excluded)')
  say(f'kernels: {json.dumps(ops.launch_counts())}' + (
      f'; peak device memory '
      f'{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB'
      if device.type == 'cuda' else ''))

  tr.finalize_saves()
  if args.checkpoint_dir and last_saved_step != max(steps, start_step):
    say(f'saved final checkpoint: {tr.save(args.checkpoint_dir)}')
  if tb_writer is not None:
    tb_writer.close()
  if mesh is not None:
    multihost.shutdown()


if __name__ == '__main__':
  main()
