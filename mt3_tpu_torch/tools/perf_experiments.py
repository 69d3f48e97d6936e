"""Decode-throughput experiment runner (port of tools/perf_experiments.py,
with its variants, flags and printed lines).

Usage:
  python -m mt3_tpu_torch.tools.perf_experiments --variant int8_cross \
      --batch 256
  python -m mt3_tpu_torch.tools.perf_experiments --variant int4_cross_gqa1 \
      --batch 1024 --steps_per_iter 16 --cache_carry stacked --profile DIR

Each variant runs the full transcription program (log-mel -> encoder ->
full-length decode with forbid_eos, or beam search with --num_beams > 1)
on the flagship mt3 model with random weights (torch seed 0) and prints
ms per pass and audio-s/s.  A pass ends with its tokens copied to the
host, which waits for the device.

The variants are the JAX tool's, field by field on the port's ModelConfig.
Their bucket size (and --bucket) is accepted and printed, but changes
nothing: the port allocates the full-length cache once and kernel B reads
only the live prefix (mt3_tpu_torch/infer/decode.py), so there are no
buckets.  --steps_per_iter is the number of decode steps between two
all-done checks (one host sync each), for greedy decode and beam search
alike.  'pallas_v3' with --cache_carry stacked raises, as the JAX
package's check does.

--profile DIR writes a chrome trace of one more pass (CUDA activity only
on a card: the kernels and the runtime calls) to DIR/trace.json.gz, which
tools/bucket_fit reads.  Runs on CUDA unless --device cpu (then every time
is the host CPU's).
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import os
import shutil
import time

import numpy as np
import torch

from mt3_tpu_torch import bench
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as config_lib
from mt3_tpu_torch.device import describe, resolve_device
from mt3_tpu_torch.models import t5
from mt3_tpu_torch.ops import spectrogram

VARIANTS = {
    # (cache_update, attention_impl, bucket_size[, kv_quantize])
    'onehot_nobucket': ('onehot', 'xla', 1024),
    'onehot_bucket': ('onehot', 'xla', 128),
    'xla_bucket': ('dus', 'xla', 128),
    'xla_nobucket': ('dus', 'xla', 1024),
    'pallas_v3': ('dus', 'pallas_v3', 1024),
    'xla_bucket64': ('dus', 'xla', 64),
    'int8': ('dus', 'xla', 128, True),
    'int8_bucket256': ('dus', 'xla', 256, True),
    # int8 self-attn cache AND int8 cross-attention K/V.
    'int8_cross': ('dus', 'xla', 128, True, True),
    # Grouped-query attention: 1 KV head shared by all 6 query heads.
    'int8_cross_gqa1': ('dus', 'xla', 128, True, True, 1),
    'gqa1': ('dus', 'xla', 128, False, False, 1),
    # int4 self-attn cache (+ int8 cross K/V).
    'int4_cross': ('dus', 'xla', 128, True, True, None, 4),
    # int8 x int8 attention products with exact integer sums.
    'int8dot_cross': ('dus', 'xla_int8dot', 128, True, True),
    # GQA (1 KV head) + int4 cache + int8 cross: the production decode.
    'int4_cross_gqa1': ('dus', 'xla', 128, True, True, 1, 4),
}


def variant_config(name, base, cache_carry=None):
  """(the variant's ModelConfig over `base` in bf16, its bucket size)."""
  variant = VARIANTS[name]
  cache_update, attn_impl, bucket = variant[:3]
  kv_quantize = len(variant) > 3 and variant[3]
  cross_quantize = len(variant) > 4 and variant[4]
  num_kv_heads = variant[5] if len(variant) > 5 else None
  kv_bits = variant[6] if len(variant) > 6 else 8
  return dataclasses.replace(
      base, dtype='bfloat16', decode_cache_update=cache_update,
      decode_attention_impl=attn_impl, decode_kv_quantize=kv_quantize,
      decode_cross_kv_quantize=cross_quantize, num_kv_heads=num_kv_heads,
      decode_kv_bits=kv_bits,
      **({'decode_cache_carry': cache_carry} if cache_carry else {})), bucket


def make_transcribe(params, model_config, spec_config, run, num_beams=0,
                    steps_per_iter=1):
  """The tool's device program: frames -> tokens on the frames' device
  (mt3_tpu_torch.bench's greedy program, or beam search)."""
  if num_beams <= 1:
    greedy = bench.make_transcribe(params, model_config, spec_config, run,
                                   forbid_eos=True,
                                   steps_per_iter=steps_per_iter)
    return lambda frames: greedy(frames)[0]
  from mt3_tpu_torch.infer import beam_search

  def transcribe(frames):
    with torch.inference_mode():
      mel = spectrogram.compute_logmel(spectrogram.flatten_frames(frames),
                                       spec_config)
      encoded = t5.encode(params, model_config, mel)
      return beam_search.beam_search(
          params, model_config, encoded, run.targets_length,
          num_beams=num_beams, forbid_eos=True,
          steps_per_iter=steps_per_iter)[0]

  return transcribe


def export_trace(profiler, directory):
  """The profiler's chrome trace as directory/trace.json.gz."""
  os.makedirs(directory, exist_ok=True)
  path = os.path.join(directory, 'trace.json')
  profiler.export_chrome_trace(path)
  with open(path, 'rb') as src, gzip.open(path + '.gz', 'wb',
                                          compresslevel=1) as dst:
    shutil.copyfileobj(src, dst)
  os.remove(path)
  return path + '.gz'


def build_parser():
  parser = argparse.ArgumentParser()
  parser.add_argument('--variant', default='xla_bucket',
                      choices=sorted(VARIANTS))
  parser.add_argument('--batch', type=int, default=256)
  parser.add_argument('--iters', type=int, default=2)
  parser.add_argument('--bucket', type=int, default=None,
                      help='the JAX tool\'s cache-growth bucket size: '
                           'printed, no effect (the port has no buckets)')
  parser.add_argument('--steps_per_iter', type=int, default=1,
                      help='decode steps between two all-done checks')
  parser.add_argument('--profile', default=None,
                      help='write a chrome trace of one more pass to '
                           'DIR/trace.json.gz')
  parser.add_argument('--cache_carry', default=None,
                      choices=['scan', 'stacked'],
                      help='decode_cache_carry override (stacked = '
                           'in-place column writes to the stacked cache)')
  parser.add_argument('--num_beams', type=int, default=0,
                      help='>1: decode with beam search (forbid_eos, '
                           'full-length worst case) instead of greedy')
  parser.add_argument('--device', default=None,
                      help="'cuda' (the default) or 'cpu'")
  return parser


def main(argv=None):
  args = build_parser().parse_args(argv)
  device = resolve_device(args.device)
  print(describe(device), flush=True)

  config = config_lib.mt3_config()
  model_config, bucket = variant_config(args.variant, config.model,
                                        args.cache_carry)
  if args.bucket:
    bucket = args.bucket
  spec_config = config.spectrogram
  run = config.run
  params = params_lib.init_params(model_config, device=device)
  rng = np.random.RandomState(0)
  frames = torch.from_numpy(rng.randn(
      args.batch, run.inputs_length,
      spec_config.hop_width).astype(np.float32)).to(device)
  transcribe = make_transcribe(params, model_config, spec_config, run,
                               args.num_beams, args.steps_per_iter)
  seg_seconds = run.inputs_length / spec_config.frames_per_second

  tag = (f'{args.variant} batch={args.batch} spi={args.steps_per_iter}'
         + (f' beams={args.num_beams}' if args.num_beams > 1 else '')
         + f' bucket={bucket} (no effect)')
  t0 = time.perf_counter()
  transcribe(frames).cpu()
  print(f'{tag}: compile+run {time.perf_counter() - t0:.1f}s', flush=True)
  times = []
  for _ in range(args.iters):
    t0 = time.perf_counter()
    transcribe(frames).cpu()
    times.append(time.perf_counter() - t0)
  dt = min(times)
  print(f'{tag}: {dt * 1000:.0f} ms '
        f'-> {args.batch * seg_seconds / dt:.1f} audio_s/s', flush=True)

  if args.profile:
    from torch.profiler import ProfilerActivity, profile
    activities = ([ProfilerActivity.CUDA] if device.type == 'cuda'
                  else [ProfilerActivity.CPU])
    with profile(activities=activities) as prof:
      t0 = time.perf_counter()
      transcribe(frames).cpu()
      dt = time.perf_counter() - t0
    path = export_trace(prof, args.profile)
    print(f'{tag}: profiled iter {dt * 1000:.0f} ms -> trace in '
          f'{args.profile} ({os.path.basename(path)})', flush=True)


if __name__ == '__main__':
  main()
