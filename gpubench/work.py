"""The yardstick's arithmetic: published peaks, least times and model FLOPs.

Frozen copies, so that a later change to the program cannot move them:
`bound`, `PEAK_*`, `_logmel_work`, `_b_variant_bytes`, `_flash_work` and
`KERNEL_KINDS` are chip_smoke.py's (lines 235-243, 285-289, 448-461,
830-838, 1346-1352 and 1656-1675 of the file as this benchmark was
written).  The per-layer model FLOP count that the `mfu.*` metrics divide
by is this benchmark's own.
"""

from __future__ import annotations

import math

# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, dense bf16 on the tensor cores, and HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# float32-accurate products on the tensor cores: three TF32 products (495
# TFLOP/s dense) per float32 product.
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES_PER_S = 3.35e12

# Kernel names -> kind (cuBLAS names its GEMM kernels nvjet_*, *gemm*,
# cutlass_* or *xmma*).  A kernel that matches none is elementwise work:
# elementwise ops, reductions and copies.
KERNEL_KINDS = (
    ('kernel C (flash attention)', ('flash_fwd', 'flash_bwd_')),
    ('kernel B (decode attention)', ('decode_attention_split_kernel',
                                     'decode_attention_grouped_')),
    ('kernel A (logmel)', ('logmel_fft_kernel',)),
    ('matmuls (cuBLAS)', ('nvjet', 'gemm', 'cutlass', 'xmma')),
)
ELEMENTWISE = 'elementwise, reductions, copies'


def kernel_kind(name: str) -> str:
  return next((kind for kind, marks in KERNEL_KINDS
               if any(mark in name for mark in marks)), ELEMENTWISE)


def bound(flops, nbytes, peak_flops=PEAK_FP32_FLOPS):
  """(least ms, 'operations' or 'bytes': which of the two sets it)."""
  ops_ms = flops / peak_flops * 1e3
  bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
  return (max(ops_ms, bytes_ms),
          'operations' if ops_ms >= bytes_ms else 'bytes')


def logmel_work(fft_size, hop_width, num_mel_bins, b, n, mel_nnz):
  """(flops, bytes) an FFT-based log-mel needs for [b, n] samples.  Per
  frame: the window, a real FFT of fft_size points (2.5 N log2 N flops),
  the magnitude (4 a bin), the mel product over the filters' nonzeros and
  the clamp + log; bytes: the audio once, the output once, the window and
  the nonzero mel weights with their indices."""
  frames = b * n // hop_width
  n_freq = fft_size // 2 + 1
  fft_flops = 2.5 * fft_size * math.log2(fft_size)
  flops = frames * (fft_size + fft_flops + 4 * n_freq + 2 * mel_nnz
                    + 2 * num_mel_bins)
  nbytes = 4 * (b * n + frames * num_mel_bins + fft_size + 2 * mel_nnz)
  return flops, nbytes


def b_variant_bytes(b, kv, h, d, index, bits, elt):
  """Bytes a decode-attention call must move: the live prefix of both
  caches (codes and scales, or values), q, new K/V and out, and the
  written column."""
  per_position = (2 * d * (bits / 8 if bits else elt)
                  + (2 * 4 if bits else 0))
  return (b * kv * index * per_position          # the live prefix
          + b * h * d * elt * 2                  # q and out
          + 2 * b * kv * d * elt                 # new K/V
          + b * kv * per_position)               # the written column


def flash_work(b, h, lq, lk, d, causal, elt):
  """(flops, bytes) the function of each entry point of flash attention
  needs: 'fwd' reads q, k, v and writes o and the row log-sum-exp; 'bwd'
  is the whole backward as autograd calls it, once: it reads q, k, v, o,
  dO and lse and writes dq, dk, dv (s, dP, dV, dK, dQ: 10 flops per pair,
  and di).  'dkv' and 'dq' are the two backward kernels alone."""
  pairs = b * h * lq * lk * d * (0.5 if causal else 1.0)
  q_bytes, kv_bytes, rows = (b * h * lq * d * elt, b * h * lk * d * elt,
                             b * h * lq * 4)
  di_flops = 2 * b * h * lq * d
  return {
      'fwd': (4 * pairs, q_bytes + 2 * kv_bytes + q_bytes + rows),
      'dkv': (8 * pairs, 2 * q_bytes + 2 * kv_bytes + 2 * rows + 2 * kv_bytes),
      'dq': (6 * pairs + di_flops,
             3 * q_bytes + 2 * kv_bytes + rows + q_bytes + rows),
      'bwd': (10 * pairs + di_flops,
              3 * q_bytes + 2 * kv_bytes + rows + q_bytes + 2 * kv_bytes),
  }


# ---------------------------------------------------------------------------
# Model FLOPs, per layer from shapes (the `mfu.*` metrics).
#
# A dense product of [m, k] by [k, n] is 2 m k n.  Attention is q.k and
# p.v, 4 q_len k_len (heads x head_dim) a row, halved when causal.  The
# embedding is a lookup and counts nothing; rematerialised work counts
# nothing.  A training step is 3x its forward.
# ---------------------------------------------------------------------------
def _kv_heads(cfg):
  return cfg.get('num_kv_heads') or cfg['num_heads']


def _attention_projections(cfg, q_rows, kv_rows):
  joined = cfg['num_heads'] * cfg['head_dim']
  kv_joined = _kv_heads(cfg) * cfg['head_dim']
  emb = cfg['emb_dim']
  return (2 * q_rows * emb * joined * 2            # query and out
          + 2 * kv_rows * emb * kv_joined * 2)     # key and value


def _mlp(cfg, rows):
  return 2 * rows * cfg['emb_dim'] * cfg['mlp_dim'] * (
      len(cfg['mlp_activations']) + 1)


def encoder_flops(cfg, frames):
  """One segment of `frames` encoder positions."""
  joined = cfg['num_heads'] * cfg['head_dim']
  per_layer = (_attention_projections(cfg, frames, frames)
               + 4 * frames * frames * joined + _mlp(cfg, frames))
  return (2 * frames * cfg['input_depth'] * cfg['emb_dim']
          + cfg['num_encoder_layers'] * per_layer)


def cross_kv_flops(cfg, frames):
  """The cross-attention keys and values of one segment, every layer."""
  kv_joined = _kv_heads(cfg) * cfg['head_dim']
  return cfg['num_decoder_layers'] * 2 * (
      2 * frames * cfg['emb_dim'] * kv_joined)


def decoder_train_flops(cfg, targets, frames):
  """One teacher-forced row of `targets` positions over `frames` encoder
  positions, cross K/V included."""
  joined = cfg['num_heads'] * cfg['head_dim']
  emb = cfg['emb_dim']
  per_layer = (_attention_projections(cfg, targets, targets)
               + 4 * targets * targets * joined * 0.5      # causal
               + 2 * targets * emb * joined * 2            # cross q, out
               + 4 * targets * frames * joined
               + _mlp(cfg, targets))
  return (cfg['num_decoder_layers'] * per_layer + cross_kv_flops(cfg, frames)
          + 2 * targets * emb * cfg['vocab_size'])


def train_step_flops(cfg, batch, targets, frames):
  return 3 * batch * (encoder_flops(cfg, frames)
                      + decoder_train_flops(cfg, targets, frames))


def decode_step_flops(cfg, rows, index, frames):
  """One incremental decode step of `rows` rows at cache position `index`
  (index + 1 positions attended), over `frames` encoder positions."""
  joined = cfg['num_heads'] * cfg['head_dim']
  emb = cfg['emb_dim']
  per_layer = (_attention_projections(cfg, 1, 1)
               + 4 * (index + 1) * joined
               + 2 * emb * joined * 2 + 4 * frames * joined + _mlp(cfg, 1))
  return rows * (cfg['num_decoder_layers'] * per_layer
                 + 2 * emb * cfg['vocab_size'])


def mel_nonzeros(mel_matrix) -> int:
  return int((mel_matrix != 0).sum())
