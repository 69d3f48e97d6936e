"""Decode step time against the cache index, fitted from a chrome trace
(counterpart of tools/bucket_fit.py, with its flags).

Given a trace of one transcription pass (written by
`python -m mt3_tpu_torch.tools.perf_experiments --profile DIR`), find
kernel B's launches, fit two step times against the cache index, and turn
the cache-read fit's slope into an effective cache-read bandwidth.

The JAX tool fits while-loop regions, one per 128-slot cache bucket.  The
port's decode allocates the full-length cache once and has no buckets, so
no while regions: the fit keys on kernel B instead.  Each decode step
launches it once per decoder layer, so launch L*k starts step k, whose
cache index is k (it reads k + 1 positions).  Two fits:

  (i)  the interval from the start of step k to the start of step k + 1,
       what the JAX tool's fit read.  On a card whose host sets the pace
       this is mostly host time.
  (ii) the sum of the L kernel-B durations of step k: the cache reads.

Both leave out the step after each all-done check (one host sync every
--spi steps), whose interval holds the sync; the count left out is
printed.  The bandwidth is (ii)'s slope over the bytes of one cache slot:
K and V codes plus, for int8/int4 caches, one float32 scale each per
(layer, row, K/V head, position), as the benchmark's kernel B bound
(gpubench/work.py b_variant_bytes) counts them.  (The JAX tool divides
the scale bytes by the bucket size, as if a scale were read once a
bucket; it is read once a position, like its code.)
--bucket is accepted and ignored.

Usage:
  python -m mt3_tpu_torch.tools.perf_experiments --variant int4_cross_gqa1 \
      --batch 1024 --steps_per_iter 16 --cache_carry stacked --profile DIR
  python -m mt3_tpu_torch.tools.bucket_fit DIR --batch 1024 --spi 16 \
      --kv_heads 1
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os

import numpy as np

# The kernel names of kernel B (csrc/decode_attention.cu): the multi-head
# split kernel and the grouped kernels.
KERNEL_B = ('decode_attention_split_kernel', 'decode_attention_grouped_')


def load_kernels(profile_dir: str):
  """(name, start us, duration us) of every device kernel in the chrome
  traces (*.json or *.json.gz) under profile_dir, by start."""
  paths = sorted(glob.glob(os.path.join(profile_dir, '**', '*.json*'),
                           recursive=True))
  paths = [p for p in paths if p.endswith(('.json', '.json.gz'))]
  if not paths:
    raise SystemExit(f'no chrome trace (*.json, *.json.gz) under '
                     f'{profile_dir}')
  kernels = []
  for path in paths:
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as f:
      trace = json.load(f)
    events = trace['traceEvents'] if isinstance(trace, dict) else trace
    for e in events:
      if e.get('ph') == 'X' and str(e.get('cat', '')).lower() == 'kernel':
        kernels.append((e['name'], float(e['ts']), float(e.get('dur', 0))))
  kernels.sort(key=lambda k: k[1])
  return kernels


def slot_bytes(layers, batch, kv_heads, head_dim, kv_bits):
  """Bytes of one cache position over every layer, row and K/V head: K
  and V codes (or values), plus two float32 scales for int8/int4."""
  quantized = kv_bits in (4, 8)
  return layers * batch * kv_heads * (2 * head_dim * kv_bits / 8
                                      + (2 * 4 if quantized else 0))


def step_series(kernels, layers, spi):
  """Per decode step k (cache index k): (indices, interval ms of fit (i),
  indices, kernel-B ms of fit (ii), steps left out), from kernel B's
  launches in `kernels`."""
  launches = [(ts, dur) for name, ts, dur in kernels
              if any(mark in name for mark in KERNEL_B)]
  if len(launches) < 3 * layers or len(launches) % layers:
    raise SystemExit(
        f'found {len(launches)} kernel B launches: need a whole number of '
        f'decode steps of {layers} layers, at least 3 (is the trace of a '
        'decode pass, and --layers right?)')
  steps = len(launches) // layers
  starts = np.array([launches[k * layers][0] for k in range(steps)])
  busy = np.array([sum(d for _, d in launches[k * layers:(k + 1) * layers])
                   for k in range(steps)])
  after_check = np.array([k > 0 and k % spi == 0 for k in range(steps)])
  # Interval of step k: start of k to start of k + 1 (the last step has
  # none); the step before a check ends with the check.
  interval_k = np.arange(steps - 1)
  keep_i = ~after_check[1:]
  keep_ii = ~after_check
  return (interval_k[keep_i], np.diff(starts)[keep_i] / 1e3,
          np.arange(steps)[keep_ii], busy[keep_ii] / 1e3,
          int(after_check.sum()), steps)


def fit(x, y):
  """(fixed ms, slope ms per slot) of a least-squares line."""
  slope, fixed = np.polyfit(np.asarray(x, np.float64),
                            np.asarray(y, np.float64), 1)
  return float(fixed), float(slope)


def build_parser():
  parser = argparse.ArgumentParser()
  parser.add_argument('profile_dir')
  parser.add_argument('--batch', type=int, default=1024)
  parser.add_argument('--spi', type=int, default=16,
                      help='decode steps between two all-done checks')
  parser.add_argument('--bucket', type=int, default=128,
                      help='ignored: the port\'s decode has no buckets')
  parser.add_argument('--max_len', type=int, default=1024)
  parser.add_argument('--layers', type=int, default=8)
  parser.add_argument('--kv_heads', type=int, default=6)
  parser.add_argument('--head_dim', type=int, default=64)
  parser.add_argument('--kv_bits', type=int, default=4)
  parser.add_argument('--top', type=int, default=0,
                      help='also dump the top-N device kernels by time')
  return parser


def main(argv=None):
  args = build_parser().parse_args(argv)
  kernels = load_kernels(args.profile_dir)

  if args.top:
    agg, cnt = collections.Counter(), collections.Counter()
    for name, _, dur in kernels:
      agg[name] += dur
      cnt[name] += 1
    print('top device kernels by total time:')
    for name, dur in agg.most_common(args.top):
      print(f'  {dur / 1e3:10.3f} ms  x{cnt[name]:<6d} {name[:100]}')

  xi, yi, xii, yii, left_out, steps = step_series(kernels, args.layers,
                                                  args.spi)
  print(f'kernel B: {steps * args.layers} launches = {steps} decode steps '
        f'of {args.layers} layers (--max_len {args.max_len}); {left_out} '
        f'steps after an all-done check left out of both fits')
  for label, x, y in (('(i) step interval', xi, yi),
                      ('(ii) kernel B time', xii, yii)):
    fixed, slope = fit(x, y)
    print(f'fit {label}: fixed {fixed:.3f} ms/step + '
          f'{slope * 128 * 1e3:.2f} us per 128 cache slots '
          f'(over {len(x)} steps, mean {np.mean(y):.3f} ms)')
  nbytes = slot_bytes(args.layers, args.batch, args.kv_heads, args.head_dim,
                      args.kv_bits)
  gbps = nbytes / (slope * 1e-3) / 1e9 if slope > 0 else float('nan')
  print(f'effective cache-read BW (fit ii): {gbps:.0f} GB/s '
        f'({nbytes / 1e3:.1f} kB K+V per slot-step, batch {args.batch})')


if __name__ == '__main__':
  main()
