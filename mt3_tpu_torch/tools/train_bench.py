"""Training-step throughput benchmark (port of tools/train_bench.py, with
its flags and printed line).

Times the port's train step (forward, loss, backward, Adafactor) for the
flagship mt3 model or ismir2021 and reports ms/step, steps/s, tokens/s and
a rough model FLOP/s (6 * parameters * (input + target) tokens, the JAX
tool's model).  The batch is staged on the device once, with random mel
fed straight to the encoder, so no log-mel runs (kernel A is upstream of
this benchmark).  --flash routes attention through kernel C; without it
attention is the port's plain path (the JAX package's XLA branch).  The
first step is timed on its own ("compile+first step", the JAX line: the
port compiles nothing, so it is a warm-up step).  The steps are timed by
the host clock around work that ends in a device synchronisation.

Runs on CUDA unless --device cpu (then every time is the host CPU's).

Usage: python -m mt3_tpu_torch.tools.train_bench --batch 64 [--bf16]
           [--remat] [--flash] [--profile DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as config_lib
from mt3_tpu_torch.device import describe, resolve_device, synchronize
from mt3_tpu_torch.train import trainer as trainer_lib


def build_parser():
  parser = argparse.ArgumentParser()
  parser.add_argument('--model', default='mt3',
                      choices=['mt3', 'ismir2021'])
  parser.add_argument('--batch', type=int, default=64)
  parser.add_argument('--bf16', action='store_true')
  parser.add_argument('--remat', action='store_true')
  parser.add_argument('--remat_policy', default='full',
                      choices=['full', 'dots'])
  parser.add_argument('--flash', action='store_true',
                      help='flash attention (kernel C; no score '
                           'materialization); attention dropout is '
                           'applied as a pre-kernel V rescale')
  parser.add_argument('--no_dropout', action='store_true',
                      help='dropout_rate=0')
  parser.add_argument('--iters', type=int, default=5)
  parser.add_argument('--profile', default=None,
                      help='capture a torch.profiler chrome trace of one '
                           'step into this directory')
  parser.add_argument('--device', default=None,
                      help="'cuda' (the default) or 'cpu'")
  return parser


def count_params(params) -> int:
  """Elements over every leaf of a parameter tree."""
  return sum(p.numel() for p in params_lib.tree_leaves(params))


def main(argv=None):
  args = build_parser().parse_args(argv)
  device = resolve_device(args.device)
  print(describe(device), flush=True)

  config = (config_lib.ismir2021_config() if args.model == 'ismir2021'
            else config_lib.mt3_config())
  model_config = dataclasses.replace(
      config.model, dtype='bfloat16' if args.bf16 else 'float32',
      remat=args.remat, remat_policy=args.remat_policy,
      train_attention_impl='flash' if args.flash else 'xla',
      dropout_rate=(0.0 if args.no_dropout
                    else config.model.dropout_rate))
  run = config.run

  tr = trainer_lib.Trainer(model_config, run, device=device)
  rng = np.random.RandomState(0)
  batch = trainer_lib.make_train_batch(
      rng, args.batch, run.inputs_length, run.targets_length,
      model_config.input_depth, model_config.vocab_size)
  # Spectrogram is upstream of this benchmark; feed mel directly.
  batch['encoder_input_tokens'] = rng.randn(
      args.batch, run.inputs_length,
      model_config.input_depth).astype(np.float32)
  # Staged on the device once: no host-to-device copy inside the timing.
  batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

  t0 = time.perf_counter()
  m = tr.step(batch)
  synchronize(device)
  float(m['loss'])
  print(f'compile+first step: {time.perf_counter() - t0:.1f}s',
        flush=True)

  t0 = time.perf_counter()
  for _ in range(args.iters):
    m = tr.step(batch)
  synchronize(device)
  float(m['loss'])
  dt = (time.perf_counter() - t0) / args.iters

  # Rough FLOP model: 6 * params * (input + target) tokens.
  n_params = count_params(tr.state.params)
  tokens = args.batch * (run.inputs_length + run.targets_length)
  flops = 6 * n_params * tokens
  print(f'{args.model} batch={args.batch} bf16={args.bf16} '
        f'remat={args.remat}'
        f'/{args.remat_policy} flash={args.flash}: '
        f'{dt * 1000:.0f} ms/step, {1 / dt:.2f} steps/s, '
        f'{tokens / dt / 1e6:.2f}M tokens/s, '
        f'~{flops / dt / 1e12:.1f} TFLOP/s', flush=True)

  if args.profile:
    from mt3_tpu_torch.utils import profiling
    with profiling.trace(args.profile):
      m = tr.step(batch)
      synchronize(device)
      float(m['loss'])
    print(f'trace written to {args.profile}', flush=True)


if __name__ == '__main__':
  main()
