"""Memory bandwidth of bare decode-cache reads (port of
tools/cache_bw_bench.py, with its patterns, flags and printed lines).

At the production cache shapes ([L=8, b, h=6, d=64, len], the port's
[layer, row, K/V head, head_dim, position] layout), measures what a read
of the whole K and V cache achieves under each access pattern:

  sum          reduction over the cache: the layout's read ceiling
  scaled       per-layer M=1 attention einsums with float32 scales
  einsum       what decode does: kernel B (ops/decode_attention) per
               layer at index len - 1, on the cache variant of --dtype
               (its bytes count the scales it reads, for int8/int4)
  batched      one layer-batched einsum reading the whole cache at once
  layout_d     cache stored [..., len, d] (d minor) instead of [..., d, len]
  wide         batch 4x wider, len 4x shorter (same bytes)
  masked       scaled + a live-length logits mask
  written      scaled + one K and one V column written per layer
  interleaved  scaled + an MLP-sized matmul between layers

Every pattern but einsum is the torch ops its name describes, in bf16 with
float32 softmax.  int8 and int4 codes are in [-7, 7]; int4 is the port's
packed layout, two codes a uint8 along head_dim (so its cache bytes are
half its elements), unpacked and cast by torch ops.  The caches are built
on the device once, outside the timing; two copies (each far beyond the
50 MB L2) alternate between launches, so every launch reads its cache
cold.  --iters launches of a pattern are timed by CUDA events (on
--device cpu by the host clock; then every time is the host CPU's).  The
JAX tool differenced two scan lengths to remove its in-program cache
build; the port needs no such difference.

Usage: python -m mt3_tpu_torch.tools.cache_bw_bench [--dtype int4]
           [--batch 512] [--len 1024] [--iters 16] [--patterns all]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from mt3_tpu_torch.device import describe, resolve_device
from mt3_tpu_torch.ops import decode_attention

L, H, D = 8, 6, 64
PATTERNS = ('sum', 'scaled', 'einsum', 'batched', 'layout_d', 'wide',
            'masked', 'written', 'interleaved')
MLP = 1024


def cache_bytes(shape, dtype):
  """Bytes of a cache of logical shape `shape` ('int4' packs two codes a
  byte)."""
  n = int(np.prod(shape))
  return n // 2 if dtype == 'int4' else n * {'int8': 1, 'bfloat16': 2}[dtype]


def dequant(cache, dtype, dim, compute_dtype):
  """A cache's values in compute_dtype; int4 unpacked along `dim` (element
  2r in the low nibble, 2r + 1 in the high one) by int8 arithmetic."""
  if dtype == 'int4':
    low = ((cache & 15) ^ 8).view(torch.int8) - 8
    high = cache.view(torch.int8) >> 4
    dim = dim % cache.dim()
    cache = torch.stack([low, high], dim=dim + 1).flatten(dim, dim + 1)
  return cache.to(compute_dtype)


def build_cache(shape, dtype, gen, device, d_dim=-2):
  """A cache of logical shape `shape`, one layer at a time: bf16 normal
  values, or codes round(3 x) clipped to [-7, 7] (int4 packed along
  d_dim)."""
  packed = list(shape)
  if dtype == 'int4':
    packed[d_dim] //= 2
  store = {'int4': torch.uint8, 'int8': torch.int8,
           'bfloat16': torch.bfloat16}[dtype]
  out = torch.empty(packed, dtype=store, device=device)
  for layer in range(shape[0]):
    x = torch.randn(shape[1:], generator=gen, device=device)
    if dtype == 'bfloat16':
      out[layer] = x.to(torch.bfloat16)
      continue
    codes = torch.clamp(torch.round(x * 3.0), -7, 7).to(torch.int8)
    out[layer] = (decode_attention.pack_int4(codes.movedim(d_dim, -2))
                  .movedim(-2, d_dim) if dtype == 'int4' else codes)
  return out


def build_scales(shape, gen, device):
  """float32 scales in [0.5, ...), [L, b, h, len]."""
  return torch.randn(shape, generator=gen, device=device).abs() + 0.5


def attend(q, k, v, dtype, ks=None, vs=None, mask=None, d_minor=False,
           compute_dtype=torch.bfloat16):
  """One layer's M=1 attention of q [b, h, d] over caches [b, h, d, len]
  (or [b, h, len, d]), with per-position scales folded into the logits and
  the weights, and positions where `mask` is False dropped."""
  kd = dequant(k, dtype, -1 if d_minor else -2, compute_dtype)
  vd = dequant(v, dtype, -1 if d_minor else -2, compute_dtype)
  spec = 'bhld' if d_minor else 'bhdl'
  logits = torch.einsum(f'bhd,{spec}->bhl', q, kd).float()
  if ks is not None:
    logits = logits * ks
  if mask is not None:
    logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
  w = torch.softmax(logits, dim=-1)
  if vs is not None:
    w = w * vs
  return torch.einsum(f'bhl,{spec}->bhd', w.to(compute_dtype), vd)


# --- The patterns: each reads every layer of one cache set `c` once. -----
def sum_fn(c, dtype, cd):
  return sum(dequant(c['k'][l], dtype, -2, cd).sum(dtype=torch.float32)
             + dequant(c['v'][l], dtype, -2, cd).sum(dtype=torch.float32)
             for l in range(c['k'].shape[0]))


def scaled_fn(c, dtype, cd):
  outs = c['q']
  for l in range(c['k'].shape[0]):
    outs = attend(outs, c['k'][l], c['v'][l], dtype, c['ks'][l], c['vs'][l],
                  compute_dtype=cd)
  return outs


def plain_fn(c, dtype, cd, d_minor=False):
  """Per-layer M=1 attention without scales (layout_d, wide)."""
  outs = c['q']
  for l in range(c['k'].shape[0]):
    outs = attend(outs, c['k'][l], c['v'][l], dtype, d_minor=d_minor,
                  compute_dtype=cd)
  return outs


def einsum_fn(c, dtype, cd):
  """Kernel B per layer at index len - 1 (its column written in place)."""
  quantized = dtype != 'bfloat16'
  outs = c['q']
  for l in range(c['k'].shape[0]):
    outs = decode_attention.decode_attention_inplace(
        outs, c['new_k'], c['new_v'], c['k'][l], c['v'][l], c['index'],
        c['ks'][l] if quantized else None, c['vs'][l] if quantized else None)
  return outs


def batched_fn(c, dtype, cd):
  q = c['q']
  kd = dequant(c['k'], dtype, -2, cd)
  vd = dequant(c['v'], dtype, -2, cd)
  ql = q.expand((kd.shape[0],) + q.shape)
  logits = torch.einsum('Lbhd,Lbhdl->Lbhl', ql, kd).float()
  w = torch.softmax(logits, dim=-1).to(cd)
  out = torch.einsum('Lbhl,Lbhdl->Lbhd', w, vd)
  return out.float().mean(dim=0) + q.float() * 1e-6


def masked_fn(c, dtype, cd, live):
  positions = torch.arange(c['k'].shape[-1], device=c['k'].device)
  mask = positions[None, None, :] < live
  outs = c['q']
  for l in range(c['k'].shape[0]):
    outs = attend(outs, c['k'][l], c['v'][l], dtype, c['ks'][l], c['vs'][l],
                  mask=mask, compute_dtype=cd)
  return outs


def written_fn(c, dtype, cd, pos):
  outs = c['q']
  for l in range(c['k'].shape[0]):
    c['k'][l, ..., pos] = c['col']
    c['v'][l, ..., pos] = c['col']
    outs = attend(outs, c['k'][l], c['v'][l], dtype, c['ks'][l], c['vs'][l],
                  compute_dtype=cd)
  return outs


def interleaved_fn(c, dtype, cd):
  outs = c['q']
  b, h, d = outs.shape
  for l in range(c['k'].shape[0]):
    outs = attend(outs, c['k'][l], c['v'][l], dtype, c['ks'][l], c['vs'][l],
                  compute_dtype=cd)
    hidden = F.gelu(outs.reshape(b, h * d) @ c['wi'])
    outs = (hidden @ c['wo']).reshape(b, h, d)
  return outs


def make_set(shape, dtype, gen, device, cd, d_minor=False):
  """One cache set: K, V, scales, a query, the einsum pattern's new column
  and index, the written pattern's column and the MLP weights."""
  layers, b, h = shape[:3]
  length = shape[-2] if d_minor else shape[-1]
  d = shape[-1] if d_minor else shape[-2]
  d_dim = -1 if d_minor else -2
  c = {'k': build_cache(shape, dtype, gen, device, d_dim),
       'v': build_cache(shape, dtype, gen, device, d_dim),
       'ks': build_scales((layers, b, h, length), gen, device),
       'vs': build_scales((layers, b, h, length), gen, device),
       'q': torch.randn((b, h, d), generator=gen, device=device).to(cd)}
  c['new_k'], c['new_v'] = (
      torch.randn((b, h, d), generator=gen, device=device).to(cd)
      for _ in range(2))
  c['index'] = torch.tensor(length - 1, dtype=torch.int32, device=device)
  col = build_cache((1, b, h, d, 1), dtype, gen, device)
  c['col'] = col[0, ..., 0]
  c['wi'], c['wo'] = (
      torch.randn(s, generator=gen, device=device).to(cd) / np.sqrt(s[0])
      for s in ((h * d, MLP), (MLP, h * d)))
  return c


def timed(fn, sets, iters, device):
  """Seconds a launch of fn(set, i) over `iters` launches after one
  warm-up launch a set, alternating the sets."""
  for i, c in enumerate(sets):
    fn(c, i)
  if device.type == 'cuda':
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for i in range(iters):
      fn(sets[i % len(sets)], i)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / iters
  t0 = time.perf_counter()
  for i in range(iters):
    fn(sets[i % len(sets)], i)
  return (time.perf_counter() - t0) / iters


def report(label, sec_per_iter, bytes_per_iter):
  gbps = bytes_per_iter / sec_per_iter / 1e9
  print(f'{label:44s} {sec_per_iter * 1e3:8.2f} ms/iter  {gbps:7.1f} GB/s')


def build_parser():
  parser = argparse.ArgumentParser()
  parser.add_argument('--dtype', default='int4',
                      choices=['int4', 'int8', 'bfloat16'])
  parser.add_argument('--batch', type=int, default=512)
  parser.add_argument('--len', type=int, dest='length', default=1024)
  parser.add_argument('--iters', type=int, default=16)
  parser.add_argument('--patterns', default='all',
                      help="comma list of patterns to run (sum, scaled, "
                           "einsum, batched, layout_d, wide, masked, "
                           "written, interleaved) or 'all'")
  parser.add_argument('--device', default=None,
                      help="'cuda' (the default) or 'cpu'")
  return parser


def main(argv=None):
  args = build_parser().parse_args(argv)
  selected = (set(PATTERNS) if args.patterns == 'all'
              else set(args.patterns.split(',')))
  unknown = selected - set(PATTERNS)
  if unknown:
    raise SystemExit(f'unknown patterns {sorted(unknown)}')
  device = resolve_device(args.device)
  print(describe(device), flush=True)

  dtype, b, length = args.dtype, args.batch, args.length
  cd = torch.bfloat16
  shape = (L, b, H, D, length)
  kv_bytes = 2 * cache_bytes(shape, dtype)
  scale_bytes = 2 * 4 * L * b * H * length
  clock = 'CUDA events' if device.type == 'cuda' else 'the host clock'
  print(f'# cache [L={L}, b={b}, h={H}, d={D}, len={length}] '
        f'{dtype}, K+V = {kv_bytes / 1e9:.2f} GB/iter, '
        f'iters {args.iters} timed by {clock}, 2 cache copies alternating',
        flush=True)

  shape_w = (L, b * 4, H, D, length // 4)
  rows = {
      'sum': ('sum: reduce K+V', lambda c, i: sum_fn(c, dtype, cd),
              kv_bytes),
      'scaled': ('scaled: einsum + fp32 scales (production)',
                 lambda c, i: scaled_fn(c, dtype, cd),
                 kv_bytes + scale_bytes),
      'einsum': ('einsum: kernel B per layer (decode)',
                 lambda c, i: einsum_fn(c, dtype, cd),
                 kv_bytes + (scale_bytes if dtype != 'bfloat16' else 0)),
      'batched': ('batched: single layer-folded einsum',
                  lambda c, i: batched_fn(c, dtype, cd), kv_bytes),
      'layout_d': ('layout_d: [.., len, d] per-layer einsum',
                   lambda c, i: plain_fn(c, dtype, cd, d_minor=True),
                   kv_bytes),
      'wide': (f'wide: batch {b * 4} x len {length // 4} per-layer einsum',
               lambda c, i: plain_fn(c, dtype, cd),
               2 * cache_bytes(shape_w, dtype)),
      'masked': ('masked: + live-length logits mask',
                 lambda c, i: masked_fn(c, dtype, cd, length // 2 + i),
                 kv_bytes + scale_bytes),
      'written': ('written: + per-iter K/V column writes',
                  lambda c, i: written_fn(c, dtype, cd, i % length),
                  kv_bytes + scale_bytes),
      'interleaved': ('interleaved: + MLP matmul between layers',
                      lambda c, i: interleaved_fn(c, dtype, cd),
                      kv_bytes + scale_bytes),
  }
  # Patterns that read caches of one shape and layout share their sets.
  groups = ((('sum', 'scaled', 'einsum', 'batched'), shape, False),
            (('layout_d',), (L, b, H, length, D), True),
            (('wide',), shape_w, False),
            (('masked', 'written', 'interleaved'), shape, False))
  gen = torch.Generator(device=device).manual_seed(0)
  for names, set_shape, d_minor in groups:
    names = [n for n in names if n in selected]
    if not names:
      continue
    sets = [make_set(set_shape, dtype, gen, device, cd, d_minor)
            for _ in range(2)]
    for name in names:
      label, fn, nbytes = rows[name]
      report(label, timed(fn, sets, args.iters, device), nbytes)
    del sets
    if device.type == 'cuda':
      torch.cuda.empty_cache()


if __name__ == '__main__':
  main()
