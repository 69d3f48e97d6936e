"""The yardstick's arithmetic against hand counts at small shapes."""

import math

import pytest

from gpubench import work

CFG = {'emb_dim': 4, 'num_heads': 2, 'head_dim': 3, 'mlp_dim': 5,
       'mlp_activations': ['gelu', 'linear'], 'num_encoder_layers': 1,
       'num_decoder_layers': 1, 'vocab_size': 7, 'input_depth': 6,
       'num_kv_heads': None}


def test_bound_picks_the_larger_time():
  assert work.bound(67e9, 0) == (1.0, 'operations')
  assert work.bound(0, 3.35e9) == (pytest.approx(1.0), 'bytes')
  assert work.bound(989e9, 0, work.PEAK_BF16_FLOPS)[0] == pytest.approx(1.0)


def test_logmel_work_by_hand():
  # 2 rows of 8 samples, hop 4 -> 4 frames; fft 8 -> 5 bins; 3 mel bins
  # with 4 nonzero weights.
  flops, nbytes = work.logmel_work(8, 4, 3, 2, 8, 4)
  per_frame = 8 + 2.5 * 8 * 3 + 4 * 5 + 2 * 4 + 2 * 3
  assert flops == 4 * per_frame
  assert nbytes == 4 * (16 + 4 * 3 + 8 + 2 * 4)


def test_decode_attention_bytes_by_hand():
  # b 2, 1 K/V head, 2 query heads, d 4, index 3, bf16: prefix 2*1*3*(2*4*2),
  # q and out 2*2*4*2*2, new K/V 2*2*1*4*2, column 2*1*(2*4*2).
  assert work.b_variant_bytes(2, 1, 2, 4, 3, None, 2) == (96 + 64 + 32 + 32)
  # int4 codes with float32 scales: 2 d / 2 + 8 bytes a position.
  assert work.b_variant_bytes(1, 1, 1, 4, 1, 4, 2) == (12 + 16 + 16 + 12)


def test_flash_work_by_hand():
  w = work.flash_work(1, 1, 2, 2, 1, False, 2)
  assert w['fwd'][0] == 16            # 4 flops a pair, 4 pairs
  assert w['fwd'][1] == 4 + 8 + 4 + 8  # q, k, v, o, lse
  assert w['bwd'][0] == 10 * 4 + 2 * 2
  assert work.flash_work(1, 1, 2, 2, 1, True, 2)['fwd'][0] == 8


def test_encoder_flops_by_hand():
  f = 3   # frames
  proj = 2 * f * 6 * 4
  attn = 2 * f * 4 * 6 * 2 + 2 * f * 4 * 6 * 2 + 4 * f * f * 6
  mlp = 2 * f * 4 * 5 * 3
  assert work.encoder_flops(CFG, f) == proj + attn + mlp


def test_decoder_and_step_flops_by_hand():
  t, f = 2, 3
  self_attn = 2 * t * 4 * 6 * 4 + 4 * t * t * 6 * 0.5
  cross = 2 * t * 4 * 6 * 2 + 4 * t * f * 6 + 2 * f * 4 * 6 * 2
  mlp = 2 * t * 4 * 5 * 3
  logits = 2 * t * 4 * 7
  dec = self_attn + cross + mlp + logits
  assert work.decoder_train_flops(CFG, t, f) == dec
  assert work.train_step_flops(CFG, 5, t, f) == 3 * 5 * (
      work.encoder_flops(CFG, f) + dec)
  step = (2 * 4 * 6 * 4 + 4 * 3 * 6 + 2 * 4 * 6 * 2 + 4 * f * 6
          + 2 * 4 * 5 * 3 + 2 * 4 * 7)
  assert work.decode_step_flops(CFG, 2, 2, f) == 2 * step


def test_mt3_pass_is_about_sixty_nine_teraflops():
  """ISSUE 15's hand estimate of a bulk pass: about 69 TFLOP."""
  cfg = {'emb_dim': 512, 'num_heads': 6, 'head_dim': 64, 'mlp_dim': 1024,
         'mlp_activations': ['gelu', 'linear'], 'num_encoder_layers': 8,
         'num_decoder_layers': 8, 'vocab_size': 1536, 'input_depth': 512}
  total = sum(work.decode_step_flops(cfg, 1024, i, 256) for i in range(1024))
  total += 1024 * (work.encoder_flops(cfg, 256) + work.cross_kv_flops(cfg, 256))
  assert 60e12 < total < 80e12


def test_kernel_kinds():
  assert work.kernel_kind('void flash_fwd_kernel<Bf16Ops>(x)') == (
      'kernel C (flash attention)')
  assert work.kernel_kind('nvjet_tst_128x64') == 'matmuls (cuBLAS)'
  assert work.kernel_kind('vectorized_elementwise_kernel') == work.ELEMENTWISE
  assert math.isclose(work.PEAK_TF32X3_FLOPS * 3, 495e12)
