"""Run the PyTorch port (mt3_tpu_torch) on one NVIDIA GPU and check it.

Usage, from the root of the repository, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from mt3_tpu_torch/csrc/ (nvcc, at
first use, one process per source, all at once) and the native TFRecord
reader (g++ on native/tfrecord.cc), then runs its phases;
each raises on failure:

  1. environment: torch / CUDA versions, the card's name and power limit;
     TF32 off for matmul and cuDNN.
  2. build: kernels A (logmel), B (decode_attention: the multi-head kernel
     and the grouped kernel) and C (forward, dQ with di, dK/dV:
     flash_attention_tc in bfloat16 on the tensor cores, flash_attention in
     float32 on FMAs) compiled concurrently, timed, with ptxas' report;
     beside them the native TFRecord reader, rebuilt from its source.
  3. kernels A and B against their plain PyTorch versions on the card, at
     the shapes the served path gives them, timed beside their bounds and,
     where one exists, a one-call PyTorch yardstick (never used by the
     port).  A (FFT log-mel): at [8, 32768], on 37-frame segments (not a
     multiple of its 8 frames per block) and on silence (log(eps)
     exactly); held within 5e-3 of a float64 rfft log-mel, and of the
     plain version plus the plain version's own error against it at each
     entry (its dense float32 DFT errs where a bin is near zero); timed at
     [8, 32768] and at the training batch [64, 32768].  B (split-length
     decode attention), multi-head float caches: at the split boundaries
     and one index past the end, b 1 and 8, float32 and bf16, head dims 64,
     16 and 8; after CUDA-graph replays with the index changed on the device;
     timed at index 127, 511 and 1023 beside SDPA.  B's grouped kernels
     (tensor cores for bf16 at head dim 64, FMAs otherwise): grouped
     float32/bf16 caches (2, 3, 6 query heads per K/V head), int8 and
     packed int4 caches (1, 2, 3, 6), the same boundaries, b and head dims
     on caches of 1024 and 100 positions (64-position blocks merged in the
     launch); every variant at b=1024, where one block walks a row's whole
     prefix, at every tile boundary; codes and scales equal to the plain
     write; graph replays in both regimes; timed at b 8 and 1024, 6 or 1
     K/V heads, index 127/511/1023, beside SDPA(enable_gqa) for the float
     cache.
  4. the served path at mt3 width: load_transcriber('mt3') (bfloat16,
     random weights from torch seed 0) answers 3 requests; A's and B's
     launch counts are checked against the segment batches and decode
     steps that ran; the CLI transcribes a written wav to MIDI.  Then one
     request per decode mode that the production configuration does not
     run (GQA, int8, int4, int8 GQA), each launching its variant of B.
  5. kernel path against plain path through the whole model in float32:
     one segment batch, 256 decode steps on the card with the kernels,
     the same tokens through the plain path on the CPU; multi-head float
     caches, then the production decode configuration.
  6. where the time goes, under torch.profiler: one served segment batch
     (64 decode steps), and one bf16 training step at mt3 width, b=64:
     wall time, device busy time, top kernels.
  7. kernel C against its plain version on the card at the training
     shapes (b=64, 6 heads x 64; (256, 256) full, (1024, 1024) causal,
     (1024, 256) full), at ragged lengths ((1000, 1000) causal, (1000,
     200) full), with sm_scale 0.125, and on transposed [b, len, h, d]
     views; float32 and bfloat16 (held against the float32 plain version
     on the same rounded inputs), forward and backward; each bf16 entry
     point and the whole backward timed at the training shapes beside its
     bounds, its TFLOP/s, the plain version and
     scaled_dot_product_attention as the yardstick.
  8. training at mt3 width: (a) a float32 train step on the card against
     the same step through the plain path on the CPU; (b) the Trainer in
     bf16 with flash attention and dropout 0.1 at b=64: 5 steps on one
     make_train_batch batch and one step on a synthetic pipeline batch
     whose log-mel comes from kernel A, with kernel C's launches checked
     per step, then 2 steps with remat; (c) the training CLI for 3 steps
     with a checkpoint, then resumed to step 4.
  9. bench.py's workload through the port: 1024 segments of random frames
     (numpy seed 0), log-mel, encoder and the full 1024-token decode with
     forbid_eos, in the JAX package's production decode configuration
     (bf16, int4 self-attention cache, int8 cross K/V, one K/V head, the
     stacked carry, 16 steps per iteration), then the same batch with
     multi-head bf16 caches: audio-s/s, ms per step, peak memory, kernel B
     launches, and 16 profiled decode steps from index 511 (with kernel B's
     device ms).
 10. evaluating a trained checkpoint: examples/quickstart.py's model
     trained 150 steps on the card, saved, reloaded as load_transcriber
     reloads a checkpoint and scored by the evaluator greedy and with 4
     beams (onset F1 at least 0.9, kernels A and B counted); beam search at
     mt3 width (float32, MHA, b=2 x 4 beams, 128 steps) on the card against
     the plain path on the CPU, each top-k compared and the CPU then held
     to the card's choice (at most one near tie); one batch of 8 segments
     at mt3 width, bf16, random weights, greedy and with 4 beams, with MHA
     bf16 caches and in the production configuration: audio-s/s, ms per
     step, peak memory and kernel B launches; the evaluate CLI on a
     checkpoint and the transcribe CLI with --num_beams 4.
 11. the flagship training recipe from a corpus on disk
     (tools/run_flagship.sh): a held-out directory of 4 wav+MIDI pairs and
     a Slakh-schema TFRecord written with the port's modules; the train
     CLI (in this process, so that its launches are counted) at mt3 width
     and depth, batch 256, remat, bf16 flash, on polysynth:64:1000 through
     a segment cache it builds and preloads, with evaluation, TensorBoard
     logs and asynchronous checkpoints, for 6 steps; resumed to step 8 from
     the checkpoint with the cache read shard by shard; 2 steps on the Slakh
     TFRecord.  Kernel A's launches equal the staged batches plus the
     evaluation's segment batches, C's the steps' (and the evaluation
     encoder's), B runs in the evaluation; the checkpoint at step 3
     reloads; the logs hold the train and eval scalars.  Each kernel is
     then held against its plain version at the shapes of these runs: A
     on a b=256 batch from the cache and on an evaluation segment batch,
     C in bf16 at b=256 on the three attention shapes and at the
     evaluation's b=8, B at the evaluation's b=8.  The native TFRecord
     reader (built in phase 2) is held byte for byte against the Python
     one on written records and NoteSequences, and both are timed on the
     cache; batches/s out of the cache (16 batches each way) and one step
     fed from it under the profiler give the data layer's host cost.

 12. the ('data', 'model') mesh (mt3_tpu_torch/parallel/), one process per
     rank, this script run again with --mesh_worker, every rank started at
     once beside this process's single-process references: (a) one NCCL
     rank on a (1, 1) mesh: Trainer(mesh=) 2 float32 steps and
     Transcriber(mesh=) one request (256 decode steps) equal to the
     mesh-free run; (b) two ranks sharing the one card over gloo on CUDA
     tensors (NCCL refuses two ranks on one card), on (1, 2) and (2, 1):
     bench.py's first 8 segments, 256 greedy float32 steps with MHA caches
     and in the production configuration (its one K/V head replicated over
     'model'), tokens equal to one process's but at near ties; 3 float32
     train steps at b=8, losses within 2e-4 relative; on (1, 2) a
     checkpoint restored in one process, 2 bf16 flash steps with dropout
     0.1 at b=64 (kernel C's launches per step), kernels B (h=3, and 3
     query heads over 1 K/V head, int4) and C (h=3) against their plain
     versions at a rank's shapes, and which collectives gloo runs on CUDA
     tensors; on (2, 1) load_transcriber('mt3') in bf16 answers one
     request; the train CLI under torchrun, two gloo ranks on (1, 2), 2
     bf16 steps, its checkpoint restored in one process.  Each rank counts its launches between a reset and its main
     path's end; they are added to the kernels line.  Every rank shares
     the card and the host, so its times are of time-sharing, not of a
     multi-GPU run.

`--phases kernels,serve,...` runs a subset (environment and build always
run) and prints no result lines.

Every direct call of a kernel, of its plain version and of its library
yardstick is timed by replaying a CUDA graph of back-to-back calls (device
time, free of the host's launch gaps).  Two kinds of call are timed by
events around back-to-back calls instead, because a graph cannot capture
them: calls through autograd, and kernel A's plain version, which copies
its DFT and mel matrices from the host on every call.

The last lines of standard output are the `kernels` JSON line, the card
line from nvidia-smi and {"ok": true, "device": {...}}.  Details go to
chiprun_out/chip_smoke.json.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import time
import wave

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / 'chiprun_out'
WORK_DIR = ROOT / 'build' / 'chip_smoke'

# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, dense bf16 on the tensor cores, and HBM bandwidth.  Bounds below
# use them.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

LOGMEL_ATOL = 5e-3        # as tests/test_pallas_logmel.py holds the TPU kernel
LOGMEL_EPS = 1e-5         # the safe log's floor (ops/spectrogram.safe_log)
ATTN_ATOL_F32 = 1e-5      # as tests/test_pallas_decode_attention.py
ATTN_TOL_BF16 = 1e-2      # x (1 + |out|): bf16 output rounding is 2**-9 relative
FORCED_LOGITS_ATOL = 1e-3
# Phase 5 in the production decode configuration, one step at a time from
# the card's state: the card's and the CPU's float32 projections differ in
# their last bits, so a value within that of a rounding boundary takes the
# neighbouring code (at most one level, at no more than 0.2% of codes).  At
# a step that writes such a code (one int4 level is a seventh of its
# vector's max) the logits are held within 0.1, at every other step within
# FORCED_LOGITS_ATOL as for float caches, and the scales written within
# 1e-4 relative (float32 sums of 512 products in another order).
FORCED_LOGITS_ATOL_QUANTIZED = 0.1
FORCED_CODE_FLIPS = 2e-3
FORCED_SCALE_RTOL = 1e-4
TOP2_GAP = 1e-3
FLASH_ATOL_F32 = 1e-4      # on o, float32: sums of <= 1024 float32 products
FLASH_GRAD_TOL_F32 = 1e-3  # x (1 + |g|) on dq, dk, dv
FLASH_TOL_BF16 = 1e-2      # tile_rel_err, bf16 vs float32 (see phase_flash)
TRAIN_LOSS_RTOL = 1e-5     # phase 8a: float32 step, card vs CPU
TRAIN_GRAD_NORM_RTOL = 1e-4
TRAIN_UPDATE_RTOL = 1e-3   # x max |update| of each leaf

RESULTS = {}
DEVICE = 'cuda'


def log(msg):
  print(msg, flush=True)


def bound(flops, nbytes, peak_flops=PEAK_FP32_FLOPS):
  ops_ms = flops / peak_flops * 1e3
  bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
  return (max(ops_ms, bytes_ms),
          'operations' if ops_ms >= bytes_ms else 'bytes')


def time_ms(torch, fn, iters, warmup=3):
  for _ in range(warmup):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters, warmup=3):
  """Device time of one call of fn: `iters` calls captured in one CUDA
  graph and replayed between two events.  Events around back-to-back calls
  (time_ms) also count the time the host takes to launch them, which on a
  shared host can exceed a small kernel's own."""
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(warmup):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(iters):
      fn()
  graph.replay()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  graph.replay()
  end.record()
  torch.cuda.synchronize()
  # cuBLAS keeps a workspace for every stream it ran on, here the warm-up
  # and capture streams (32 MiB each on this card); free them, so that the
  # peak memory of later phases does not count them.
  torch._C._cuda_clearCublasWorkspaces()
  return start.elapsed_time(end) / iters


def rotating(fn, argument_sets):
  """A call of fn on the next argument set of a cycle: successive calls
  read different tensors, as successive layers of a step do."""
  cycle = itertools.cycle(argument_sets)
  return lambda: fn(*next(cycle))


def chord_clip(seconds, seed, sample_rate=16000):
  """A chord of sines that changes every half second, plus a little noise."""
  rng = np.random.RandomState(seed)
  t = np.arange(int(seconds * sample_rate)) / sample_rate
  audio = np.zeros_like(t)
  for start in np.arange(0.0, seconds, 0.5):
    pitches = rng.choice(np.arange(48, 84), size=3, replace=False)
    window = (t >= start) & (t < start + 0.5)
    for p in pitches:
      freq = 440.0 * 2 ** ((p - 69) / 12)
      audio += window * 0.2 * np.sin(2 * np.pi * freq * t)
  return (audio + 0.01 * rng.randn(t.size)).astype(np.float32)


# ---------------------------------------------------------------------------
def _write_wav(path, audio, sample_rate=16000):
  pcm = np.clip(audio * 32767, -32768, 32767).astype(np.int16)
  with wave.open(str(path), 'wb') as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(sample_rate)
    w.writeframes(pcm.tobytes())


def phase_environment(torch):
  log(f'python {sys.version.split()[0]}  torch {torch.__version__}  '
      f'cuda {torch.version.cuda}')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True)
  card = smi.stdout.strip().splitlines()[0]
  log(card)
  torch.backends.cudnn.allow_tf32 = False
  assert torch.backends.cuda.matmul.allow_tf32 is False
  assert torch.backends.cudnn.allow_tf32 is False
  assert torch.get_float32_matmul_precision() == 'highest'
  RESULTS['card'] = card
  RESULTS['torch'] = torch.__version__
  RESULTS['cuda'] = torch.version.cuda
  return card


def phase_build():
  """The CUDA kernels (one nvcc each, at once) and, beside them, the
  native TFRecord reader (g++ on native/tfrecord.cc), always rebuilt here
  from the checkout's source."""
  from mt3_tpu_torch.data import tfrecord
  from mt3_tpu_torch.ops import cuda_build
  tfrecord.library_path().unlink(missing_ok=True)
  native = {}

  def build_native():
    begin = time.perf_counter()
    try:
      native['path'] = tfrecord._build_library()
    except RuntimeError as e:
      native['error'] = e
    native['s'] = time.perf_counter() - begin

  thread = threading.Thread(target=build_native)
  thread.start()
  start = time.perf_counter()
  try:
    paths = cuda_build.build(['logmel', 'decode_attention',
                              'flash_attention', 'flash_attention_tc'])
  finally:
    thread.join()
  seconds = time.perf_counter() - start
  if 'error' in native:
    raise native['error']
  log(f'built the native TFRecord reader in {native["s"]:.1f}s: '
      f'{native["path"]}')
  RESULTS['native_build_s'] = native['s']
  for name, (secs, report) in cuda_build.BUILD_LOGS.items():
    lines = [l for l in report.splitlines() if 'registers' in l or 'spill' in l]
    log(f'built {name} in {secs:.1f}s: ' + ' | '.join(l.strip() for l in lines))
  log(f'phase 2 build: {seconds:.1f}s -> {sorted(str(p) for p in paths.values())}')
  RESULTS['build_s'] = seconds
  for name in paths:
    cuda_build.library(name)


def phase_kernels(torch):
  return {'logmel': _kernel_a(torch), 'decode_attention': _kernel_b(torch),
          **_kernel_b_variants(torch)}


def _logmel_rfft(audio, cfg, dtype=np.float64):
  """log-mel of [b, n] audio by a real FFT in `dtype` and the float32 mel
  weights.  In float64 (numpy's rfft) it is the yardstick of accuracy for
  kernel A and its plain version alike; in float32 (scipy's pocketfft,
  which computes in single precision) it shows how close float32
  arithmetic itself comes to that yardstick on the same audio."""
  import scipy.fft
  from mt3_tpu_torch.ops import spectrogram
  hop, fft = cfg.hop_width, cfg.fft_size
  padded = np.pad(audio.astype(dtype), [(0, 0), (0, fft - hop)])
  frames = np.lib.stride_tricks.sliding_window_view(
      padded, fft, axis=-1)[:, ::hop]
  window = spectrogram.hann_window(fft).astype(dtype)
  mel = np.abs(scipy.fft.rfft(frames * window)) @ (
      spectrogram._mel_matrix(cfg).astype(dtype))
  return np.log(np.where(mel <= 0, LOGMEL_EPS, mel).astype(np.float64))


def _logmel_work(cfg, b, n, mel_nnz):
  """(flops, bytes) an FFT-based log-mel needs for [b, n] samples.  Per
  frame: the window, a real FFT of fft_size points (2.5 N log2 N flops),
  the magnitude (4 a bin), the mel product over the filters' nonzeros and
  the clamp + log; bytes: the audio once, the output once, the window and
  the nonzero mel weights with their indices."""
  frames = b * n // cfg.hop_width
  n_freq = cfg.fft_size // 2 + 1
  fft_flops = 2.5 * cfg.fft_size * math.log2(cfg.fft_size)
  flops = frames * (cfg.fft_size + fft_flops + 4 * n_freq + 2 * mel_nnz
                    + 2 * cfg.num_mel_bins)
  nbytes = 4 * (b * n + frames * cfg.num_mel_bins + cfg.fft_size
                + 2 * mel_nnz)
  return flops, nbytes


def _logmel_check(torch, audio, label, float64_atol=LOGMEL_ATOL):
  """Kernel A against its plain version on [b, n] float32 audio (numpy).

  The plain version's dense float32 DFT is itself off the function where a
  bin's magnitude falls near zero (its rounding error follows the frame's
  energy, not the bin's).  So the kernel is held within LOGMEL_ATOL of the
  plain version plus the plain version's own error against a float64 rfft
  log-mel at that entry, and within `float64_atol` of the float64 log-mel
  itself; float64_atol=None holds the kernel's worst error against the
  float64 log-mel to the plain version's instead (on recorded audio, whose
  quiet bins sit near the log's floor, float32 arithmetic itself misses
  LOGMEL_ATOL there: the float32 rfft's error is reported beside it)."""
  from mt3_tpu_torch.core.config import SpectrogramConfig
  from mt3_tpu_torch.ops import logmel

  cfg = SpectrogramConfig()
  x = torch.from_numpy(audio).to(DEVICE)
  got = logmel.logmel_fused(x, cfg, LOGMEL_EPS)
  want = logmel.logmel_plain(x, cfg, LOGMEL_EPS)
  torch.cuda.synchronize()
  assert got.shape == want.shape == (
      audio.shape[0], audio.shape[1] // cfg.hop_width, cfg.num_mel_bins), (
          label, got.shape)
  assert torch.isfinite(got).all(), label
  truth = _logmel_rfft(audio, cfg)
  got, want = got.cpu().numpy(), want.cpu().numpy()
  diff = np.abs(got - want)
  plain_err = np.abs(want - truth)
  kernel_err = np.abs(got - truth)
  check = dict(
      max_abs_err=float(diff.max()),
      kernel_vs_float64=float(kernel_err.max()),
      plain_vs_float64=float(plain_err.max()),
      float32_rfft_vs_float64=float(np.abs(
          _logmel_rfft(audio, cfg, np.float32) - truth).max()),
      entries_over_atol=int((diff > LOGMEL_ATOL).sum()),
      worst_excess=float((diff - (LOGMEL_ATOL + plain_err)).max()))
  limit = check['plain_vs_float64'] if float64_atol is None else float64_atol
  log(f'kernel A logmel {label}: max_abs_err vs plain '
      f'{check["max_abs_err"]:.3e} ({check["entries_over_atol"]} of '
      f'{diff.size} entries over {LOGMEL_ATOL}); against float64 rfft: '
      f'kernel {check["kernel_vs_float64"]:.3e}, plain '
      f'{check["plain_vs_float64"]:.3e}, float32 rfft '
      f'{check["float32_rfft_vs_float64"]:.3e}; limits: |kernel - plain| <= '
      f'{LOGMEL_ATOL} + |plain - float64| (worst excess '
      f'{check["worst_excess"]:.3e}), max |kernel - float64| <= {limit:.3e}'
      + (' (the plain version\'s)' if float64_atol is None else ''))
  assert check['worst_excess'] <= 0, (label, check)
  assert check['kernel_vs_float64'] <= limit, (label, check)
  return check


def _kernel_a(torch):
  """Kernel A against its plain version: the served shape, a segment whose
  frame count is not a multiple of the kernel's 8 frames per block, and
  silence; then timed at the served and the training batch."""
  from mt3_tpu_torch.core.config import SpectrogramConfig
  from mt3_tpu_torch.ops import logmel, spectrogram

  dev = torch.device(DEVICE)
  cfg = SpectrogramConfig()
  hop, sr = cfg.hop_width, cfg.sample_rate

  def clips(b, frames, seed):
    return np.stack([chord_clip(frames * hop / sr, seed=seed + s)
                     for s in range(b)])

  checks = {label: _logmel_check(torch, audio, label) for label, audio in (
      ('8x32768', clips(8, 256, 0)), ('3x4736 (37 frames)', clips(3, 37, 20)))}
  silent = logmel.logmel_fused(torch.zeros(2, 20 * hop, device=dev), cfg,
                               LOGMEL_EPS)
  log_eps = torch.tensor(np.log(np.float32(LOGMEL_EPS)), dtype=torch.float32)
  assert torch.equal(silent.cpu(), log_eps.expand(silent.shape)), silent
  log(f'kernel A logmel: silence gives log(eps) = {float(log_eps)!r} exactly')
  err = max(c['max_abs_err'] for c in checks.values())

  mel_nnz = int(np.count_nonzero(spectrogram._mel_matrix(cfg)))
  timings = {}
  for b in (8, 64):
    n = 256 * hop
    x = torch.from_numpy(clips(b, 256, 100)).to(dev)
    flops, nbytes = _logmel_work(cfg, b, n, mel_nnz)
    bound_ms, bound_by = bound(flops, nbytes)
    ms = graph_ms(torch, lambda: logmel.logmel_fused(x, cfg), 20)
    # Events: the plain version's host-to-device copies cannot be captured.
    plain_ms = time_ms(torch, lambda: logmel.logmel_plain(x, cfg),
                       20 if b == 8 else 5)
    timings[b] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, flops=flops, bytes=nbytes)
    log(f'kernel A logmel [{b}, {n}]: kernel_ms {ms:.5f}  plain_ms '
        f'{plain_ms:.4f}  library_ms null  bound_ms {bound_ms:.6f} '
        f'({bound_by}, {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.2f} MB; '
        f'{bound_ms / ms:.2%} of bound)')
  RESULTS['logmel'] = dict(checks=checks, timings=timings,
                           mel_nonzeros=mel_nnz)
  served = timings[8]
  return dict(
      name='logmel', route='cuda', source='mt3_tpu_torch/csrc/logmel.cu',
      replaces='mt3_tpu/ops/pallas/logmel.py:81', max_abs_err=err,
      ms=served['ms'], plain_ms=served['plain_ms'],
      bound_ms=served['bound_ms'], bound_by=served['bound_by'],
      library_ms=None)


def _kernel_b(torch):
  """Kernel B against its plain version at the split boundaries, both
  dtypes, head dims 64, 16 and 8 and b in {1, 8}; after CUDA-graph replays with a
  changed index; then timed at the served shape."""
  import torch.nn.functional as F
  from mt3_tpu_torch.ops import decode_attention

  dev = torch.device(DEVICE)
  split = decode_attention.L_SPLIT
  errors = {torch.float32: 0.0, torch.bfloat16: 0.0}
  gen = torch.Generator(device=dev).manual_seed(0)

  def make(b, h, d, length, dtype):
    q = torch.randn(b, h, d, device=dev, generator=gen) / 8
    nk, nv = (torch.randn(b, h, d, device=dev, generator=gen)
              for _ in range(2))
    ck, cv = (torch.randn(b, h, d, length, device=dev, generator=gen)
              for _ in range(2))
    return [t.to(dtype) for t in (q, nk, nv, ck, cv)]

  cases = 0
  for (h, d), dtype, length, b in itertools.product(
      ((6, 64), (4, 16), (4, 8)), (torch.float32, torch.bfloat16),
      (128, 512, 1024),
      (1, 8)):
    indices = sorted({0, 1, split - 1, split, split + 1, 2 * split, 511, 512,
                      length - 1} & set(range(length))) + [length + 5]
    for index in indices:
      q, nk, nv, ck, cv = make(b, h, d, length, dtype)
      idx = torch.tensor(index, dtype=torch.int32, device=dev)
      k1, v1 = ck.clone(), cv.clone()
      got = decode_attention.decode_attention_inplace(q, nk, nv, k1, v1, idx)
      want, plain_caches = _variant_plain(torch, [q, nk, nv, ck, cv, None,
                                                  None], idx)
      torch.cuda.synchronize()
      label = (b, h, d, str(dtype), length, index)
      errors[dtype] = max(errors[dtype], _check_variant(
          torch, got, want, (k1, v1), plain_caches, (ck, cv), index, dtype,
          label))
      cases += 1
  log(f'kernel B decode_attention: {cases} calls at split boundaries (L_split '
      f'{split}), b 1 and 8, head dims 64, 16 and 8, lengths 128/512/1024, one '
      f'index past the end each: max_abs_err f32 {errors[torch.float32]:.3e} '
      f'(atol {ATTN_ATOL_F32}), bf16 {errors[torch.bfloat16]:.3e} (tolerance '
      f'{ATTN_TOL_BF16} x (1 + |out|)); caches equal to the plain write')

  # CUDA-graph replay: one call captured, then replayed with the index
  # changed in device memory; three replays exercise the counter reset.
  for dtype in (torch.float32, torch.bfloat16):
    q, nk, nv, ck, cv = make(8, 6, 64, 1024, dtype)
    idx = torch.tensor(5, dtype=torch.int32, device=dev)
    k1, v1 = ck.clone(), cv.clone()
    decode_attention.decode_attention_inplace(q, nk, nv, k1, v1, idx)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
      out = decode_attention.decode_attention_inplace(q, nk, nv, k1, v1, idx)
    for index in (700, split + 1, 1023):
      k1.copy_(ck)
      v1.copy_(cv)
      idx.fill_(index)
      graph.replay()
      want, plain_caches = _variant_plain(torch, [q, nk, nv, ck, cv, None,
                                                  None], idx)
      torch.cuda.synchronize()
      errors[dtype] = max(errors[dtype], _check_variant(
          torch, out, want, (k1, v1), plain_caches, (ck, cv), index, dtype,
          ('graph', str(dtype), index)))
    del graph
  log('kernel B decode_attention: CUDA-graph replays at index 700, '
      f'{split + 1}, 1023 (float32 and bf16) agree with the plain version')

  # The production batch of phase 9's MHA run: b=1024, h=6 gives 6144
  # (batch, head) rows of counters and partials.
  for dtype in (torch.bfloat16, torch.float32):
    q, nk, nv, ck, cv = make(1024, 6, 64, 1024, dtype)
    for index in (127, 511, 1023):
      idx = torch.tensor(index, dtype=torch.int32, device=dev)
      k1, v1 = ck.clone(), cv.clone()
      got = decode_attention.decode_attention_inplace(q, nk, nv, k1, v1, idx)
      want, plain_caches = _variant_plain(torch, [q, nk, nv, ck, cv, None,
                                                  None], idx)
      torch.cuda.synchronize()
      errors[dtype] = max(errors[dtype], _check_variant(
          torch, got, want, (k1, v1), plain_caches, (ck, cv), index, dtype,
          ('b=1024', str(dtype), index)))
      del k1, v1, got, want, plain_caches
    del q, nk, nv, ck, cv
  log('kernel B decode_attention: b=1024, h=6, d=64, len 1024 at index 127, '
      '511, 1023 (float32 and bf16) agrees with the plain version; max_abs_err '
      f'f32 {errors[torch.float32]:.3e}, bf16 {errors[torch.bfloat16]:.3e}')

  # Timed at the served shape and dtype.  As in a served step, each call
  # takes the next of 8 layers' caches (8 x 12.6 MB, twice the 50 MB L2),
  # so the prefix comes from HBM as the bytes bound assumes.
  b, h, d, length, dtype = 8, 6, 64, 1024, torch.bfloat16
  layers = [make(b, h, d, length, dtype) for _ in range(8)]

  timings = {}
  for index in (127, 511, 1023):
    idx = torch.tensor(index, dtype=torch.int32, device=dev)
    kernel = rotating(
        lambda *a: decode_attention.decode_attention_inplace(*a, idx), layers)
    ms = graph_ms(torch, kernel, 200)
    plain_ms = graph_ms(torch, rotating(
        lambda *a: decode_attention.decode_attention_plain(*a, idx), layers),
        200)
    # Yardstick only: attention over the pre-transposed live prefix, over
    # the same 8 layers' worth of caches.
    yard = [(q[:, :, None, :],
             ck[..., :index + 1].transpose(-1, -2).contiguous(),
             cv[..., :index + 1].transpose(-1, -2).contiguous())
            for q, _, _, ck, cv in layers]
    library = rotating(
        lambda q, kt, vt: F.scaled_dot_product_attention(q, kt, vt,
                                                         scale=1.0), yard)
    library_ms = graph_ms(torch, library, 200)
    elt = 2
    nbytes = (2 * b * h * d * index * elt     # K and V prefix read
              + 3 * b * h * d * elt           # q, new k, new v
              + b * h * d * elt               # out
              + 2 * b * h * d * elt)          # the written column
    flops = 4 * b * h * d * (index + 1)
    bound_ms, bound_by = bound(flops, nbytes)
    timings[index] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
    log(f'kernel B decode_attention [b={b}, h={h}, d={d}, len={length}, '
        f'index={index}, bf16]: kernel_ms {ms:.5f}  plain_ms {plain_ms:.5f}  '
        f'library_ms {library_ms:.5f} (kernel {ms / library_ms:.2f}x SDPA)  '
        f'bound_ms {bound_ms:.6f} ({bound_by}, {nbytes / 1e6:.2f} MB; '
        f'{bound_ms / ms:.1%} of bound)')
    if index == 1023:
      # The event-timed readings of earlier runs, for comparison only: at
      # this size they include the host's launch time.
      RESULTS['decode_attention_events_ms'] = dict(
          kernel=time_ms(torch, kernel, 200),
          library=time_ms(torch, library, 200))
    del yard
  RESULTS['decode_attention'] = dict(
      timings=timings, bf16_max_abs_err=errors[torch.bfloat16],
      f32_max_abs_err=errors[torch.float32], checked_calls=cases)
  last = timings[1023]
  return dict(
      name='decode_attention', route='cuda',
      source='mt3_tpu_torch/csrc/decode_attention.cu',
      replaces='mt3_tpu/ops/pallas/decode_attention_v3.py:159',
      max_abs_err=errors[torch.float32], ms=last['ms'],
      plain_ms=last['plain_ms'], bound_ms=last['bound_ms'],
      bound_by=last['bound_by'], library_ms=last['library_ms'])


# ---------------------------------------------------------------------------
# Kernel B's grouped and quantized variants
# ---------------------------------------------------------------------------
# variant -> (K/V heads of 6 for the timed shape, cache bits or None)
B_VARIANTS = {'gqa': (1, None), 'int8': (6, 8), 'int4': (6, 4),
              'int8_gqa': (1, 8), 'int4_gqa': (1, 4)}
B_TIMED_BATCHES = (8, 1024)
B_ENTRY_BATCH = 1024   # the kernels line reports the production batch


def _variant_make(torch, gen, b, h, kv, d, length, dtype, bits):
  """One call's inputs on the card: query [b, h, d] and new K/V [b, kv, d]
  in `dtype`; caches in it, or int8 / packed int4 codes with float32
  scales in [0.2, 1] / levels."""
  from mt3_tpu_torch.ops import decode_attention
  q = (torch.randn(b, h, d, device=DEVICE, generator=gen) / 8).to(dtype)
  nk, nv = (torch.randn(b, kv, d, device=DEVICE, generator=gen).to(dtype)
            for _ in range(2))
  if bits is None:
    ck, cv = (torch.randn(b, kv, d, length, device=DEVICE,
                          generator=gen).to(dtype) for _ in range(2))
    return [q, nk, nv, ck, cv, None, None]
  levels = 7 if bits == 4 else 127
  codes = [torch.randint(-levels, levels + 1, (b, kv, d, length),
                         device=DEVICE, generator=gen, dtype=torch.int8)
           for _ in range(2)]
  ck, cv = (decode_attention.pack_int4(c) if bits == 4 else c
            for c in codes)
  ks, vs = ((torch.rand(b, kv, length, device=DEVICE, generator=gen) * 0.8
             + 0.2) / levels for _ in range(2))
  return [q, nk, nv, ck, cv, ks, vs]


def _clone(tensors):
  return [None if t is None else t.clone() for t in tensors]


def _variant_plain(torch, args, idx):
  """The plain write in the query's dtype (the codes and scales the kernel
  must write) on copies of the caches, and the plain output in float32
  over them: the kernel computes in float32 and rounds only its output."""
  from mt3_tpu_torch.ops import decode_attention
  q, nk, nv, ck, cv, ks, vs = args
  k2, v2, ks2, vs2 = _clone([ck, cv, ks, vs])
  decode_attention.write_column(nk, nv, k2, v2, idx, ks2, vs2)
  quant = ks is not None
  want = decode_attention.attention_plain(
      q.float(), k2 if quant else k2.float(), v2 if quant else v2.float(),
      idx, ks2, vs2)
  return want, [k2, v2, ks2, vs2]


def _check_variant(torch, got, want, written, plain_written, before, index,
                   dtype, label):
  """A kernel B call against the plain version: output within the dtype's
  tolerance, caches (and scales) equal to the plain write, positions past
  index as they were.  Returns the max abs error."""
  assert got.dtype == dtype and torch.isfinite(got.float()).all(), label
  for w, p, b in zip(written, plain_written, before):
    if w is None:
      continue
    assert torch.equal(w, p), label
    assert torch.equal(w[..., index + 1:], b[..., index + 1:]), label
  diff = (got.float() - want).abs()
  if dtype == torch.float32:
    assert float(diff.max()) <= ATTN_ATOL_F32, (label, float(diff.max()))
  else:
    excess = diff - ATTN_TOL_BF16 * (1 + want.abs())
    assert float(excess.max()) <= 0, (label, float(diff.max()))
  return float(diff.max())


def _b_variant_bytes(b, kv, h, d, index, bits, elt):
  """Bytes a call must move: the live prefix of both caches (codes and
  scales, or values), q, new K/V and out, and the written column."""
  per_position = (2 * d * (bits / 8 if bits else elt)
                  + (2 * 4 if bits else 0))
  return (b * kv * index * per_position          # the live prefix
          + b * h * d * elt * 2                  # q and out
          + 2 * b * kv * d * elt                 # new K/V
          + b * kv * per_position)               # the written column


def _kernel_b_variants(torch):
  """Kernel B's grouped kernel against its plain version for every
  variant, then timed by graph replay at b=8 and 1024, h=6, d=64, len
  1024, index 127/511/1023, bf16, beside SDPA(enable_gqa) for the float
  GQA cache."""
  import torch.nn.functional as F
  from mt3_tpu_torch.ops import decode_attention

  gen = torch.Generator(device=DEVICE).manual_seed(5)
  split = decode_attention.L_SPLIT
  errors = {}
  cases = 0
  for (name, bits, groups), dtype, d, b in itertools.product(
      (('gqa', None, (2, 3, 6)), ('int8', 8, (1, 2, 3, 6)),
       ('int4', 4, (1, 2, 3, 6))),
      (torch.float32, torch.bfloat16), (64, 16, 8), (1, 8)):
    # 1024, the served length; 100, whose rows are not whole 16-byte chunks
    # (the kernel's element-wise loads).
    for g, length in itertools.product(groups, (1024, 100)):
      kv = 6 // g
      indices = sorted({0, 1, split - 1, split, split + 1, 2 * split, 511,
                        512, length - 1} & set(range(length))) + [length + 5]
      for index in indices:
        args = _variant_make(torch, gen, b, 6, kv, d, length, dtype, bits)
        idx = torch.tensor(index, dtype=torch.int32, device=DEVICE)
        written = _clone(args[3:])
        got = decode_attention.decode_attention_inplace(
            *args[:3], *written[:2], idx, *written[2:])
        want, plain_written = _variant_plain(torch, args, idx)
        torch.cuda.synchronize()
        variant = decode_attention.variant(args[3], g)
        key = (variant, str(dtype).split('.')[-1])
        errors[key] = max(errors.get(key, 0.0), _check_variant(
            torch, got, want, written, plain_written, args[3:], index, dtype,
            (variant, g, d, b, str(dtype), index)))
        cases += 1
  log(f'kernel B grouped kernel: {cases} calls (grouped float32/bf16 g 2, 3, '
      f'6; int8 and int4 g 1, 2, 3, 6; head dims 64, 16 and 8; b 1 and 8; '
      f'every '
      f'split boundary of caches of 1024 and 100 positions and one index past '
      f'the end): max abs '
      f'err ' + ', '.join(f'{v} {t} {e:.3e}' for (v, t), e in
                          sorted(errors.items()))
      + f' (float32 atol {ATTN_ATOL_F32}, bf16 {ATTN_TOL_BF16} x (1 + |out|));'
      ' caches and scales equal to the plain write')

  # The whole-prefix regime: at b * kv >= GROUPED_BLOCKS one block per
  # (batch, K/V head) walks the whole live prefix and merges nothing.
  # Every variant at its timed K/V heads and b = 1024 (the production
  # batch), float32 and bf16: at head dim 64 every tile boundary of the
  # 1024-position block, the last column and one index past the end; at
  # head dims 16 and 8 (the FMA kernel in both dtypes) a few of them.
  length = 1024
  boundaries = sorted({0, 1, length - 1} | {
      k * split + e for k in range(1, length // split) for e in (-1, 0, 1)})
  whole = 0
  for name, (kv, bits) in B_VARIANTS.items():
    for dtype, d in itertools.product((torch.float32, torch.bfloat16),
                                      (64, 16, 8)):
      b = B_ENTRY_BATCH
      assert decode_attention.grouped_split(b * kv, length)[1] == 1
      args = _variant_make(torch, gen, b, 6, kv, d, length, dtype, bits)
      indices = boundaries if d == 64 else [0, split, 700, length - 1]
      for index in indices + [length + 5]:
        idx = torch.tensor(index, dtype=torch.int32, device=DEVICE)
        written = _clone(args[3:])
        got = decode_attention.decode_attention_inplace(
            *args[:3], *written[:2], idx, *written[2:])
        want, plain_written = _variant_plain(torch, args, idx)
        torch.cuda.synchronize()
        key = (name, str(dtype).split('.')[-1])
        errors[key] = max(errors.get(key, 0.0), _check_variant(
            torch, got, want, written, plain_written, args[3:], index, dtype,
            ('whole prefix', name, d, str(dtype), index)))
        whole += 1
        del written, got, want, plain_written
      del args
  cases += whole
  log(f'kernel B grouped kernel, whole-prefix blocks: {whole} calls (every '
      f'variant at b={B_ENTRY_BATCH}, float32 and bf16; d 64 at every tile '
      f'boundary of a {length}-position block, d 16 and 8 at 5 indices): max '
      f'abs err '
      + ', '.join(f'{v} {t} {e:.3e}' for (v, t), e in sorted(errors.items())))

  # CUDA-graph replays with the index changed on the device, in both
  # regimes: b=8 (64-position blocks merged in the launch) and b=1024
  # (one block a row).
  for b, (bits, g, dtype) in itertools.product(
      (8, B_ENTRY_BATCH), ((4, 6, torch.bfloat16), (8, 1, torch.float32),
                           (None, 3, torch.bfloat16), (8, 6, torch.bfloat16))):
    args = _variant_make(torch, gen, b, 6, 6 // g, 64, 1024, dtype, bits)
    idx = torch.tensor(5, dtype=torch.int32, device=DEVICE)
    written = _clone(args[3:])
    decode_attention.decode_attention_inplace(*args[:3], *written[:2], idx,
                                              *written[2:])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
      out = decode_attention.decode_attention_inplace(
          *args[:3], *written[:2], idx, *written[2:])
    for index in (700, split + 1, 1023):
      for w, a in zip(written, args[3:]):
        if w is not None:
          w.copy_(a)
      idx.fill_(index)
      graph.replay()
      want, plain_written = _variant_plain(torch, args, idx)
      torch.cuda.synchronize()
      _check_variant(torch, out, want, written, plain_written, args[3:],
                     index, dtype, ('graph', b, bits, g, index))
    del graph, args, written, out
  log('kernel B grouped kernel: CUDA-graph replays at index 700, '
      f'{split + 1}, 1023 (int4 g 6 bf16, int8 g 1 float32, bf16 g 3, int8 '
      f'g 6 bf16) at b=8 and b={B_ENTRY_BATCH} agree with the plain version')

  h, d, length, dtype = 6, 64, 1024, torch.bfloat16
  timings, timed_errors = {}, {}
  for name, (kv, bits) in B_VARIANTS.items():
    for b in B_TIMED_BATCHES:
      # Enough copies that one rotation exceeds the 50 MB L2 twice over, so
      # each call reads its prefix from HBM, as a decode step over 8
      # layers' caches does at these batches.
      per_set = _b_variant_bytes(b, kv, h, d, length, bits, 2)
      sets = [_variant_make(torch, gen, b, h, kv, d, length, dtype, bits)
              for _ in range(max(2, min(256, math.ceil(100e6 / per_set))))]
      for index in (127, 511, 1023):
        idx = torch.tensor(index, dtype=torch.int32, device=DEVICE)
        # The timed shape itself against the plain version, on copies of
        # the first set: at b=1024 the grid has b x kv rows of counters
        # (6144 for 6 K/V heads) and the partials are [b x h, 16, d + 2].
        written = _clone(sets[0][3:])
        got = decode_attention.decode_attention_inplace(
            *sets[0][:3], *written[:2], idx, *written[2:])
        want, plain_written = _variant_plain(torch, sets[0], idx)
        torch.cuda.synchronize()
        timed_errors[(name, b)] = max(
            timed_errors.get((name, b), 0.0), _check_variant(
                torch, got, want, written, plain_written, sets[0][3:], index,
                dtype, (name, b, index)))
        del written, got, want, plain_written
        iters = 200 if b == 8 else 20
        ms = graph_ms(torch, rotating(
            lambda q, nk, nv, ck, cv, ks, vs:
            decode_attention.decode_attention_inplace(q, nk, nv, ck, cv, idx,
                                                      ks, vs), sets), iters)
        plain_ms = graph_ms(torch, rotating(
            lambda q, nk, nv, ck, cv, ks, vs: (
                decode_attention.decode_attention_quantized_plain(
                    q, nk, nv, ck, cv, idx, ks, vs) if ks is not None else
                decode_attention.decode_attention_plain(
                    q, nk, nv, ck, cv, idx)), sets),
            20 if b == 8 else 3)
        library_ms = None
        if bits is None:   # yardstick only: SDPA over the live prefix
          yard = [(q[:, :, None, :],
                   ck[..., :index + 1].transpose(-1, -2).contiguous(),
                   cv[..., :index + 1].transpose(-1, -2).contiguous())
                  for q, _, _, ck, cv, _, _ in sets]
          library_ms = graph_ms(torch, rotating(
              lambda q, kt, vt: F.scaled_dot_product_attention(
                  q, kt, vt, scale=1.0, enable_gqa=True), yard), iters)
          del yard
        nbytes = _b_variant_bytes(b, kv, h, d, index, bits, 2)
        flops = 4 * b * h * d * (index + 1)
        # The products could run on the bf16 tensor cores: int8 and int4
        # codes are exact in bf16.
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        timings[(name, b, index)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
        log(f'kernel B {name} [b={b}, h={h}, kv={kv}, d={d}, len={length}, '
            f'index={index}, bf16]: kernel_ms {ms:.5f}  plain_ms '
            f'{plain_ms:.5f}  library_ms '
            + ('none' if library_ms is None else
               f'{library_ms:.5f} (kernel {ms / library_ms:.2f}x SDPA)')
            + f'  bound_ms {bound_ms:.6f} ({bound_by}, {nbytes / 1e6:.2f} '
            f'MB; {bound_ms / ms:.1%} of bound)')
      del sets
  log('kernel B grouped kernel at the timed shapes (h 6, d 64, len 1024, '
      'index 127/511/1023, bf16): outputs within the bf16 tolerance, caches '
      'and scales equal to the plain write; max abs err ' + ', '.join(
          f'{n} b={b} {e:.3e}' for (n, b), e in timed_errors.items()))
  RESULTS['decode_attention_variants'] = dict(
      checked_calls=cases,
      max_abs_err={f'{v} {t}': e for (v, t), e in errors.items()},
      timed_shape_max_abs_err={f'{n} b={b}': e
                               for (n, b), e in timed_errors.items()},
      timings={f'{n} b={b} index={i}': t
               for (n, b, i), t in timings.items()})
  kernels = {}
  for name in B_VARIANTS:
    entry = timings[(name, B_ENTRY_BATCH, 1023)]
    kernels[f'decode_attention_{name}'] = dict(
        name=f'decode_attention_{name}', route='cuda',
        source='mt3_tpu_torch/csrc/decode_attention.cu',
        replaces='mt3_tpu/ops/pallas/decode_attention_v3.py:159',
        xla_branch='mt3_tpu/models/layers.py:497',
        shape=f'b={B_ENTRY_BATCH}, h=6, kv={B_VARIANTS[name][0]}, d=64, '
              'len 1024, index 1023, bf16',
        max_abs_err=max(e for (v, t), e in errors.items()
                        if v == name and t == 'float32'),
        # bf16 at head dim 64 is the tensor-core kernel's (float32 and
        # head dim 8 take the FMA kernel).
        max_abs_err_bf16=max(e for (v, t), e in errors.items()
                             if v == name and t == 'bfloat16'),
        ms=entry['ms'], plain_ms=entry['plain_ms'],
        bound_ms=entry['bound_ms'], bound_by=entry['bound_by'],
        library_ms=entry['library_ms'])
  return kernels


def phase_serve(torch):
  import mt3_tpu_torch
  from mt3_tpu_torch.core import midi_io
  from mt3_tpu_torch.infer import transcribe
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.ops import decode_attention, logmel

  transcriber = mt3_tpu_torch.load_transcriber('mt3', device=DEVICE)
  assert transcriber.device.type == DEVICE
  config = transcriber.config
  assert config.model.dtype == 'bfloat16' and config.model.emb_dim == 512
  sr = config.spectrogram.sample_rate
  clips = [chord_clip(s, seed=10 + i) for i, s in enumerate((4.0, 10.0, 20.0))]
  batches = sum(len(transcribe.audio_to_segments(c, config)) for c in clips)

  steps = [0]
  decode_step = t5.decode_step

  def counted_decode_step(*args, **kwargs):
    steps[0] += 1
    return decode_step(*args, **kwargs)

  t5.decode_step = counted_decode_step
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  logmel.LAUNCHES = 0
  decode_attention.reset_launches()
  walls, notes = [], []
  try:
    for clip in clips:
      start = time.perf_counter()
      ns = transcriber(clip)
      torch.cuda.synchronize()
      walls.append(time.perf_counter() - start)
      notes.append(len(ns.notes))
      for note in ns.notes:
        assert math.isfinite(note.start_time) and math.isfinite(note.end_time)
        # Random weights: times are arbitrary but must be well formed.
        assert 0 <= note.start_time <= note.end_time, note
        assert 0 <= note.pitch <= 127 and 0 <= note.program <= 127, note
  finally:
    launches = {'logmel': logmel.LAUNCHES,
                'decode_attention': decode_attention.LAUNCHES}
    t5.decode_step = decode_step
  peak = torch.cuda.max_memory_allocated()
  audio_s = sum(len(c) for c in clips) / sr
  log(f'phase 4 serve: {len(clips)} requests, {audio_s:.1f} audio-s in '
      f'{sum(walls):.3f}s = {audio_s / sum(walls):.3f} audio-s/s; walls '
      f'{[round(w, 3) for w in walls]}; notes {notes}; decode steps '
      f'{steps[0]}; peak memory {peak / 2**20:.1f} MiB')
  log(f'phase 4 launches: {launches} (expected logmel {batches}, '
      f'decode_attention {config.model.num_decoder_layers} x {steps[0]})')
  assert steps[0] > 0
  assert launches['logmel'] == batches, (launches, batches)
  assert launches['decode_attention'] == (
      config.model.num_decoder_layers * steps[0]), (launches, steps[0])
  RESULTS['serve'] = dict(
      requests=len(clips), audio_s=audio_s, wall_s=walls,
      audio_s_per_s=audio_s / sum(walls), notes=notes, decode_steps=steps[0],
      segment_batches=batches, peak_memory_bytes=peak)

  # The CLI on one written wav, in its own process.
  WORK_DIR.mkdir(parents=True, exist_ok=True)
  wav_path = WORK_DIR / 'clip.wav'
  _write_wav(wav_path, clips[0], sr)
  midi_path = WORK_DIR / 'clip.mid'
  if midi_path.exists():
    midi_path.unlink()
  cli = subprocess.run(
      [sys.executable, '-m', 'mt3_tpu_torch.cli.transcribe', str(wav_path),
       '--output_dir', str(WORK_DIR)],
      cwd=ROOT, capture_output=True, text=True, timeout=600)
  log('cli: ' + (cli.stdout.strip() or cli.stderr.strip()[-2000:]))
  assert cli.returncode == 0, cli.stderr[-4000:]
  read_back = midi_io.midi_file_to_note_sequence(str(midi_path))
  log(f'cli: read back {len(read_back.notes)} notes from {midi_path.name}')
  return launches


def phase_forced_tokens(torch):
  """Kernel path against plain path through the whole model in float32:
  multi-head attention with float caches, free-running; then the
  production decode configuration (one K/V head, int4 cache, int8 cross
  K/V, stacked carry) one step at a time from the card's state."""
  RESULTS['forced_tokens'] = _forced_tokens(torch)
  RESULTS['forced_tokens_production'] = _forced_tokens_lockstep(torch)


def _forced_setup(torch, overrides):
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.infer import transcribe

  config = config_lib.mt3_config()
  model = dataclasses.replace(config.model, dtype='float32', **overrides)
  params = params_lib.init_params(model)   # torch seed 0, on the CPU
  batch = transcribe.audio_to_segments(chord_clip(10.0, seed=11), config)[0]
  return config, model, params, torch.from_numpy(batch.frames)


def _greedy(torch, logits):
  from mt3_tpu_torch.codec.vocabulary import PAD_ID
  masked = logits.clone()
  masked[..., PAD_ID] = -1e10
  top2 = masked.topk(2, dim=-1).values
  return (masked.argmax(-1).to(torch.int32),
          (top2[..., 0] - top2[..., 1]) > TOP2_GAP)


def _forced_tokens(torch):
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.ops import spectrogram

  config, model, params, frames_cpu = _forced_setup(torch, {})
  steps = 256

  def run(device, forced=None):
    p = params_lib.to_device(params, device)
    frames = frames_cpu.to(device)
    with torch.inference_mode():
      mel = spectrogram.compute_logmel(spectrogram.flatten_frames(frames),
                                       config.spectrogram)
      encoded = t5.encode(p, model, mel)
      state = t5.init_decode_state(p, model, encoded, steps)
      token = torch.zeros(frames.shape[0], dtype=torch.int32, device=device)
      logits_all, tokens = [], []
      for step in range(steps):
        logits, state = t5.decode_step(p, model, token, state)
        logits_all.append(logits)
        token = (_greedy(torch, logits)[0] if forced is None
                 else forced[step].to(device))
        tokens.append(token)
      return (mel.cpu(), encoded.cpu(), torch.stack(logits_all).cpu(),
              torch.stack(tokens).cpu())

  start = time.perf_counter()
  mel_k, enc_k, logits_k, tokens_k = run(torch.device(DEVICE))
  torch.cuda.synchronize()
  gpu_s = time.perf_counter() - start
  start = time.perf_counter()
  mel_p, enc_p, logits_p, _ = run(torch.device('cpu'), forced=tokens_k)
  cpu_s = time.perf_counter() - start
  assert torch.isfinite(logits_k).all() and torch.isfinite(logits_p).all()
  mel_err = float((mel_k - mel_p).abs().max())
  enc_err = float((enc_k - enc_p).abs().max())
  logit_err = float((logits_k - logits_p).abs().max())
  greedy, clear = _greedy(torch, logits_p)
  agree = greedy == tokens_k
  log(f'phase 5 forced tokens, mha (float32, b={tokens_k.shape[1]}, {steps} '
      f'steps): logmel err {mel_err:.3e}, encoder err {enc_err:.3e}, logits '
      f'max_abs_err {logit_err:.3e} (atol {FORCED_LOGITS_ATOL}); greedy '
      f'agrees at {int((agree & clear).sum())}/{int(clear.sum())} clear '
      f'steps; card {gpu_s:.1f}s, cpu {cpu_s:.1f}s')
  assert logit_err <= FORCED_LOGITS_ATOL, logit_err
  assert bool(agree[clear].all())
  return dict(logmel_err=mel_err, encoder_err=enc_err, logits_err=logit_err,
              clear_steps=int(clear.sum()),
              agree_steps=int((agree & clear).sum()))


def _forced_tokens_lockstep(torch, steps=256):
  """The production configuration, card against CPU, one decode step at a
  time.  The CPU's encoder takes the card's log-mel and its decoder the
  card's encoder output; after the cross K/V codes are compared, the CPU
  reads the card's.  Before every step the CPU's self-attention cache and
  index are set to the card's, both run the step on the card's greedy
  token, and the step's logits and written column are compared.  So a
  difference cannot carry from one step to the next, and what is left is
  one step's float32 arithmetic: a value within that of a rounding
  boundary may take the neighbouring code (FORCED_CODE_FLIPS)."""
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.ops import decode_attention, spectrogram

  config, model, params, frames = _forced_setup(torch, PRODUCTION)
  p_k = params_lib.to_device(params, DEVICE)

  def codes(t):
    return decode_attention.cache_codes(t.cpu()).to(torch.int32)

  start = time.perf_counter()
  with torch.inference_mode():
    mel_k = spectrogram.compute_logmel(
        spectrogram.flatten_frames(frames.to(DEVICE)), config.spectrogram)
    mel_p = spectrogram.compute_logmel(spectrogram.flatten_frames(frames),
                                       config.spectrogram)
    enc_k = t5.encode(p_k, model, mel_k)
    enc_p = t5.encode(params, model, mel_k.cpu())
    state_k = t5.init_decode_state(p_k, model, enc_k, steps)
    state_p = t5.init_decode_state(params, model, enc_k.cpu(), steps)
    flips = {}
    for name in ('cross_k', 'cross_v'):
      diff = (codes(getattr(state_k, name))
              - codes(getattr(state_p, name))).abs()
      flips[name] = [int((diff > 0).sum()), int(diff.max()), diff.numel()]
    scale_err = max(float(((getattr(state_k, n).cpu() - getattr(state_p, n))
                           / getattr(state_p, n)).abs().max())
                    for n in ('cross_k_scale', 'cross_v_scale'))
    state_p = dataclasses.replace(state_p, **{
        n: getattr(state_k, n).cpu() for n in (
            'cross_k', 'cross_v', 'cross_k_scale', 'cross_v_scale')})
    cache_k, cache_p = state_k.cache, state_p.cache
    names = ('key', 'value', 'key_scale', 'value_scale')
    b = frames.shape[0]
    token = torch.zeros(b, dtype=torch.int32, device=DEVICE)
    flips.update(key=[0, 0, 0], value=[0, 0, 0])
    clean_err = flip_err = 0.0
    flip_steps = clear_steps = agree_steps = 0
    logit_abs = []
    for step in range(steps):
      for name in names:
        getattr(cache_p, name).copy_(getattr(cache_k, name))
      state_p = dataclasses.replace(state_p, index=state_k.index.cpu())
      logits_p, state_p = t5.decode_step(params, model, token.cpu(), state_p)
      logits_k, state_k = t5.decode_step(p_k, model, token, state_k)
      logits_k = logits_k.cpu()
      assert torch.isfinite(logits_k).all() and torch.isfinite(logits_p).all()
      err = float((logits_k - logits_p).abs().max())
      logit_abs.append(logits_p.abs())
      flipped, step_scale_err = False, 0.0
      for name in ('key', 'value'):
        diff = (codes(getattr(cache_k, name))[..., step]
                - codes(getattr(cache_p, name))[..., step]).abs()
        count = int((diff > 0).sum())
        flips[name] = [flips[name][0] + count,
                       max(flips[name][1], int(diff.max())),
                       flips[name][2] + diff.numel()]
        flipped |= count > 0
        scale_k = getattr(cache_k, name + '_scale')[..., step].cpu()
        scale_p = getattr(cache_p, name + '_scale')[..., step]
        step_scale_err = max(step_scale_err, float(
            ((scale_k - scale_p) / scale_p).abs().max()))
      if flipped:
        flip_steps += 1
        flip_err = max(flip_err, err)
      else:
        clean_err = max(clean_err, err)
        scale_err = max(scale_err, step_scale_err)
      greedy_p, clear = _greedy(torch, logits_p)
      greedy_k, _ = _greedy(torch, logits_k)
      clear_steps += int(clear.sum())
      agree_steps += int((clear & (greedy_p == greedy_k)).sum())
      token = greedy_k.to(DEVICE)
  seconds = time.perf_counter() - start
  mel_err = float((mel_k.cpu() - mel_p).abs().max())
  enc_err = float((enc_k.cpu() - enc_p).abs().max())
  logit_abs = torch.stack(logit_abs)
  log(f'phase 5 forced tokens, production (float32, b={b}, {steps} steps '
      f'from the card\'s state): logmel err {mel_err:.3e}, encoder err (same '
      f'log-mel) {enc_err:.3e}; logits |mean| {float(logit_abs.mean()):.3f}, '
      f'max {float(logit_abs.max()):.3f}; logits max_abs_err '
      f'{clean_err:.3e} at the {steps - flip_steps} steps whose written '
      f'codes all agree (atol {FORCED_LOGITS_ATOL}), {flip_err:.3e} at the '
      f'{flip_steps} with a code one level apart (atol '
      f'{FORCED_LOGITS_ATOL_QUANTIZED}); codes differing (count, max levels, '
      f'of): {flips}; scales max rel err {scale_err:.3e} (cross, and the '
      f'columns of those steps; rtol {FORCED_SCALE_RTOL}); greedy agrees at {agree_steps}/{clear_steps} '
      f'clear steps; {seconds:.1f}s')
  assert clean_err <= FORCED_LOGITS_ATOL, clean_err
  assert flip_err <= FORCED_LOGITS_ATOL_QUANTIZED, flip_err
  assert scale_err <= FORCED_SCALE_RTOL, scale_err
  for name, (count, levels, size) in flips.items():
    assert levels <= 1 and count <= FORCED_CODE_FLIPS * size, (name, count)
  assert agree_steps == clear_steps, (agree_steps, clear_steps)
  return dict(logmel_err=mel_err, encoder_err=enc_err,
              logits_err=clean_err, logits_err_flip_steps=flip_err,
              flip_steps=flip_steps, code_diffs=flips, scale_rel_err=scale_err,
              logits_mean_abs=float(logit_abs.mean()),
              logits_max_abs=float(logit_abs.max()),
              clear_steps=clear_steps, agree_steps=agree_steps)


# Kernel names -> the kind reported in the profile (cuBLAS names its GEMM
# kernels nvjet_*, *gemm*, cutlass_* or *xmma*).
KERNEL_KINDS = (
    ('kernel C (flash attention)', ('flash_fwd', 'flash_bwd_')),
    ('kernel B (decode attention)', ('decode_attention_split_kernel',
                                     'decode_attention_grouped_')),
    ('kernel A (logmel)', ('logmel_fft_kernel',)),
    ('matmuls (cuBLAS)', ('nvjet', 'gemm', 'cutlass', 'xmma')),
)


def _profile(torch, run, label):
  """Wall time of run() unprofiled, then device busy time by kernel."""
  from torch.profiler import ProfilerActivity, profile
  run()  # warm up
  start = time.perf_counter()
  run()
  wall_ms = (time.perf_counter() - start) * 1e3
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    run()
  # Kernels only: CPU-side ops carry their kernels' time too, and a
  # record_function range on the device (the optimizer's step) spans
  # kernels already counted.
  by_name = {}
  for e in prof.events():
    if (e.device_type != torch.autograd.DeviceType.CUDA
        or getattr(e, 'is_user_annotation', False)
        or e.self_device_time_total <= 0):
      continue
    ms, count = by_name.get(e.name, (0.0, 0))
    by_name[e.name] = (ms + e.self_device_time_total / 1e3, count + 1)
  rows = sorted(((name, ms, count) for name, (ms, count) in by_name.items()),
                key=lambda r: -r[1])
  busy_ms = sum(r[1] for r in rows)
  share = None if not rows else 1.0 - busy_ms / wall_ms
  kinds, calls = {}, {}
  for name, ms, count in rows:
    kind = next((k for k, marks in KERNEL_KINDS if any(m in name for m in marks)),
                'elementwise, reductions, copies')
    kinds[kind] = kinds.get(kind, 0.0) + ms
    calls[kind] = calls.get(kind, 0) + count
  log(f'phase 6 profile ({label}): wall {wall_ms:.1f} ms unprofiled, device '
      f'busy {busy_ms:.1f} ms (kernel time under the profiler), idle share '
      f'{"not measured" if share is None else f"{share:.3f}"}')
  log('  device ms by kind: ' + ', '.join(
      f'{k} {v:.1f}' for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))
  for key, ms, count in rows[:10]:
    log(f'  {ms:9.3f} ms  {count:6d}x  {key[:90]}')
  return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=share,
              by_kind=kinds, calls_by_kind=calls,
              top=[list(r) for r in rows[:10]])


def phase_profile(torch):
  """Where the time goes: one served segment batch, one train step."""
  import mt3_tpu_torch
  from mt3_tpu_torch.infer import transcribe

  transcriber = mt3_tpu_torch.load_transcriber('mt3', device=DEVICE)
  config = transcriber.config
  batch = transcribe.audio_to_segments(chord_clip(4.0, seed=10), config)[0]
  frames = torch.from_numpy(batch.frames).to(DEVICE)

  def serve():
    with torch.inference_mode():
      tokens, _ = transcribe._transcribe_batch(
          transcriber.params, config.model, config.spectrogram, frames, 64,
          0.0, None)
    torch.cuda.synchronize()
    return tokens

  RESULTS['profile'] = _profile(
      torch, serve, '1 batch, log-mel + encoder + 64 decode steps')
  del transcriber

  trainer, batch = _mt3_trainer(torch, remat=False)

  def train():
    metrics = trainer.step(batch)
    torch.cuda.synchronize()
    return metrics

  RESULTS['profile_train'] = _profile(
      torch, train, f'1 bf16 train step, flash, dropout 0.1, '
      f'b={TRAIN_BATCH}')


# ---------------------------------------------------------------------------
# Decode modes and the production serving configuration
# ---------------------------------------------------------------------------
# The JAX package's production decode configuration (bench.py:95-114): int4
# self-attention cache, int8 cross-attention K/V, one K/V head, the stacked
# carry (with bf16 activations and 16 steps per iteration).
PRODUCTION = dict(decode_kv_quantize=True, decode_kv_bits=4,
                  decode_cross_kv_quantize=True, decode_cache_carry='stacked',
                  num_kv_heads=1)
# Served one clip each through the Transcriber, one per kernel B variant
# that the production configuration does not run: the transcribe CLI's
# --gqa_kv_heads 2, --int8_kv, --int8_kv --gqa_kv_heads 3, and int4 MHA.
DECODE_MODES = {
    'gqa': dict(num_kv_heads=2),
    'int8': dict(decode_kv_quantize=True, decode_cross_kv_quantize=True),
    'int4': dict(decode_kv_quantize=True, decode_kv_bits=4),
    'int8_gqa': dict(decode_kv_quantize=True, decode_cross_kv_quantize=True,
                     num_kv_heads=3),
}
PRODUCTION_SEGMENTS = 1024   # bench.py NUM_SEGMENTS


def phase_decode_modes(torch):
  """One 2-second request per decode mode through a Transcriber at mt3
  width (bf16, random weights): well-formed notes, and kernel B launched under
  the mode's variant at every layer of every decode step."""
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.infer.transcribe import Transcriber
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.ops import decode_attention

  clip = chord_clip(2.0, seed=21)
  base = config_lib.mt3_config()
  launches = {}
  for variant, overrides in DECODE_MODES.items():
    # As the transcribe CLI builds it from --int8_kv / --gqa_kv_heads.
    config = dataclasses.replace(base, model=dataclasses.replace(
        base.model, dtype='bfloat16', **overrides))
    transcriber = Transcriber(config, params_lib.init_params(config.model),
                              device=DEVICE)
    steps = [0]
    decode_step = t5.decode_step

    def counted(*args, **kwargs):
      steps[0] += 1
      return decode_step(*args, **kwargs)

    t5.decode_step = counted
    decode_attention.reset_launches()
    try:
      start = time.perf_counter()
      ns = transcriber(clip)
      torch.cuda.synchronize()
      wall = time.perf_counter() - start
    finally:
      t5.decode_step = decode_step
    counts = dict(decode_attention.VARIANT_LAUNCHES)
    for note in ns.notes:
      assert math.isfinite(note.start_time) and 0 <= note.start_time <= (
          note.end_time), note
    layers = transcriber.config.model.num_decoder_layers
    log(f'decode mode {variant} ({overrides}): {len(ns.notes)} notes, '
        f'{steps[0]} decode steps in {wall:.2f}s; kernel B launches {counts}')
    assert counts == {variant: layers * steps[0]}, (variant, counts)
    launches[f'decode_attention_{variant}'] = counts[variant]
    del transcriber
  RESULTS['decode_modes'] = launches
  return launches


def _bench_frames(torch, config):
  """bench.py's input: numpy seed 0, [1024, 256, hop_width] float32."""
  rng = np.random.RandomState(0)
  return torch.from_numpy(rng.randn(
      PRODUCTION_SEGMENTS, config.run.inputs_length,
      config.spectrogram.hop_width).astype(np.float32)).to(DEVICE)


def _serve_bench(torch, label, config, params, frames):
  """bench.py's workload through the port: log-mel (kernel A), encoder,
  the full 1024-token decode with forbid_eos and 16 steps per iteration.
  One warm pass, one timed pass; then 16 decode steps from index 511
  under the profiler."""
  from mt3_tpu_torch.infer import decode
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.ops import decode_attention, logmel, spectrogram

  model = config.model
  max_len = config.run.targets_length

  def transcribe():
    with torch.inference_mode():
      mel = spectrogram.compute_logmel(spectrogram.flatten_frames(frames),
                                       config.spectrogram)
      encoded = t5.encode(params, model, mel)
      tokens, lengths = decode.decode_tokens(
          params, model, encoded, max_len, forbid_eos=True,
          steps_per_iter=model.decode_steps_per_iter)
      return tokens.cpu(), lengths.cpu()

  transcribe()   # warm
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  decode_attention.reset_launches()
  logmel.LAUNCHES = 0
  start = time.perf_counter()
  tokens, lengths = transcribe()
  wall = time.perf_counter() - start
  launches = dict(decode_attention.VARIANT_LAUNCHES)
  logmel_launches = logmel.LAUNCHES
  peak = torch.cuda.max_memory_allocated()
  assert tokens.shape == (PRODUCTION_SEGMENTS, max_len)
  assert bool((lengths == max_len).all())
  assert int(tokens.min()) >= 0 and int(tokens.max()) < model.vocab_size
  audio_s = (PRODUCTION_SEGMENTS * config.run.inputs_length
             / config.spectrogram.frames_per_second)

  with torch.inference_mode():
    mel = spectrogram.compute_logmel(spectrogram.flatten_frames(frames),
                                     config.spectrogram)
    encoded = t5.encode(params, model, mel)
    state = t5.init_decode_state(params, model, encoded, max_len)
    token = torch.zeros(PRODUCTION_SEGMENTS, dtype=torch.int32,
                        device=DEVICE)

    def steps():
      state.index.fill_(511)
      s = state
      with torch.inference_mode():
        for _ in range(model.decode_steps_per_iter):
          _, s = t5.decode_step(params, model, token, s)
      torch.cuda.synchronize()
    profile = _profile(torch, steps, f'{label}: 16 decode steps from index '
                       f'511, b={PRODUCTION_SEGMENTS}')
  del state, encoded, mel
  b_kind = 'kernel B (decode attention)'
  b_calls = profile['calls_by_kind'].get(b_kind, 0)
  b_ms = profile['by_kind'].get(b_kind, 0.0)
  log(f'phase 9 {label}: kernel B device ms in the 16 profiled steps '
      f'{b_ms:.3f} ({b_calls} calls, '
      f'{b_ms / max(b_calls, 1):.5f} ms a call)')
  result = dict(
      audio_s=audio_s, wall_s=wall, audio_s_per_s=audio_s / wall,
      ms_per_step=wall / max_len * 1e3, peak_memory_bytes=peak,
      decode_attention_launches=launches, logmel_launches=logmel_launches,
      profile=profile)
  log(f'phase 9 {label}: {PRODUCTION_SEGMENTS} segments = {audio_s:.1f} '
      f'audio-s in {wall:.3f}s = {audio_s / wall:.3f} audio-s/s; '
      f'{wall / max_len * 1e3:.3f} ms per decode step (whole pass over '
      f'{max_len} steps); peak memory {peak / 2**30:.2f} GiB; kernel B '
      f'launches {launches} ({model.num_decoder_layers} per step); kernel A '
      f'launches {logmel_launches}')
  return result


def phase_production(torch):
  """bench.py's workload in the JAX package's production configuration
  (int4 cache, int8 cross K/V, one K/V head, stacked carry, bf16), then
  the same batch with MHA bf16 caches."""
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.core import config as config_lib

  base = config_lib.mt3_config()
  frames = _bench_frames(torch, base)
  results = {}
  for label, overrides in (('production', PRODUCTION), ('mha_bf16', {})):
    config = dataclasses.replace(base, model=dataclasses.replace(
        base.model, dtype='bfloat16', **overrides))
    params = params_lib.init_params(config.model, device=DEVICE)
    results[label] = _serve_bench(torch, label, config, params, frames)
    del params
    torch.cuda.empty_cache()
  prod = results['production']
  steps = base.run.targets_length
  expected = base.model.num_decoder_layers * steps
  assert prod['decode_attention_launches'] == {'int4_gqa': expected}, prod
  assert results['mha_bf16']['decode_attention_launches'] == {
      'mha': expected}, results['mha_bf16']
  assert prod['logmel_launches'] == 1
  RESULTS['production'] = results
  log(f'phase 9: production {prod["audio_s_per_s"]:.3f} audio-s/s against '
      f'MHA bf16 {results["mha_bf16"]["audio_s_per_s"]:.3f} on the same '
      f'batch; peak {prod["peak_memory_bytes"] / 2**30:.2f} against '
      f'{results["mha_bf16"]["peak_memory_bytes"] / 2**30:.2f} GiB')
  return {'decode_attention_int4_gqa': expected}


# ---------------------------------------------------------------------------
# Training: kernel C and the train step
# ---------------------------------------------------------------------------
TRAIN_BATCH = 64
FLASH_SHAPES = ((256, 256, False), (1024, 1024, True), (1024, 256, False))
# Checked against the plain version, not timed: ragged lengths (partial
# last tiles), sm_scale != 1 (with q unscaled), and the [b, len, h, d]
# activations that layers.attention passes as transposed views.
FLASH_CHECKS = (
    dict(lq=1000, lk=1000, causal=True),
    dict(lq=1000, lk=200, causal=False),
    dict(lq=256, lk=256, causal=False, sm_scale=0.125),
    dict(lq=1024, lk=1024, causal=True, strided=True),
)
# Kernel C's bf16 times when its products ran as float32 FMAs, per layer's
# three training calls ('bwd': the whole backward through autograd): quoted
# from PERF.md's kernel table (H100 80GB HBM3, 700 W; events around
# back-to-back calls), not measured here.  Printed in the log only.
FMA_DESIGN_QUOTED_MS = {'fwd': 3.6991, 'bwd': 12.8859}


def _flash_work(b, h, lq, lk, d, causal, elt):
  """(flops, bytes) the function of each entry point needs: forward reads
  q, k, v and writes o and the row log-sum-exp; dQ reads q, k, v, o, dO
  and lse and writes dq and di (s, dP, dQ products, and di); dK/dV reads
  q, k, v, dO, lse and di and writes dk, dv (s, dP, dV, dK).  'bwd' is the
  whole backward as autograd calls it, once: it reads q, k, v, o, dO and
  lse and writes dq, dk, dv (s, dP, dV, dK, dQ: 10 flops per pair, and
  di).  dK/dV and dQ each recompute s and dP, so their two bounds sum to
  14 flops per pair."""
  pairs = b * h * lq * lk * d * (0.5 if causal else 1.0)
  q_bytes, kv_bytes, rows = b * h * lq * d * elt, b * h * lk * d * elt, b * h * lq * 4
  di_flops = 2 * b * h * lq * d
  return {
      'fwd': (4 * pairs, q_bytes + 2 * kv_bytes + q_bytes + rows),
      'dkv': (8 * pairs, 2 * q_bytes + 2 * kv_bytes + 2 * rows + 2 * kv_bytes),
      'dq': (6 * pairs + di_flops,
             3 * q_bytes + 2 * kv_bytes + rows + q_bytes + rows),
      'bwd': (10 * pairs + di_flops,
              3 * q_bytes + 2 * kv_bytes + rows + q_bytes + 2 * kv_bytes),
  }


def tile_rel_err(got, want, tile=64):
  """Largest ||got - want||_2 / ||want||_2 over the `tile`-row blocks of
  each (batch, head) of [b, h, len, d] tensors (it bounds the same ratio
  over the whole tensor).  A last block shorter than `tile` rows counts
  its own rows."""
  import torch.nn.functional as F
  b, h, length, d = want.shape
  pad = (0, 0, 0, -length % tile)

  def norms(x):
    return F.pad(x, pad).reshape(b, h, -1, tile * d).norm(dim=-1)
  return float((norms(got - want) / norms(want)).max())


def _flash_check(torch, fa, gen, errors, lq, lk, causal, sm_scale=1.0,
                 strided=False, batch=TRAIN_BATCH, dtypes=None, heads=6):
  """Kernel C against its plain version on one call, float32 and bf16
  unless `dtypes` names others.

  float32 (the FMA kernels): the plain version on the same float32 inputs;
  atol on o and FLASH_GRAD_TOL_F32 x (1 + |w|) elementwise on the
  gradients.  bfloat16 (the tensor-core kernels, the training dtype): the
  plain version run in float32 on the same bf16-rounded q, k, v and dO,
  held by tile_rel_err <= FLASH_TOL_BF16 per output, i.e. within 1% in
  every 64-row block of every (batch, head).  An elementwise limit does
  not fit bf16 gradients: dq is a cancelling sum whose rounding error
  follows the size of its terms, not its own.  With strided=True the
  inputs are [b, len, h, d] tensors passed transposed, as layers.attention
  passes them, and the outputs must come back in the same layout.  The
  plain version runs TRAIN_BATCH rows at a time, so a larger batch does
  not hold all its float32 scores at once."""
  b, h, d = batch, heads, 64
  dev = torch.device(DEVICE)

  def make(length, scale):
    if strided:
      x = torch.randn(b, length, h, d, device=dev, generator=gen)
      return (x * scale).transpose(1, 2)
    return torch.randn(b, h, length, d, device=dev, generator=gen) * scale

  q = make(lq, 1.0 if sm_scale != 1.0 else 1 / d ** 0.5)
  k, v, do = make(lk, 1.0), make(lk, 1.0), make(lq, 0.5)
  label = (f'{lq}x{lk} {"causal" if causal else "full"}'
           + (f' sm_scale {sm_scale}' if sm_scale != 1.0 else '')
           + (' strided' if strided else '')
           + (f' b={b}' if b != TRAIN_BATCH else '')
           + (f' h={h}' if h != 6 else ''))
  for dtype in dtypes or (torch.float32, torch.bfloat16):
    name = str(dtype).split('.')[-1]
    inputs = [t.to(dtype) for t in (q, k, v, do)]
    args = [t.clone().requires_grad_() for t in inputs[:3]]
    o = fa.flash_attention(*args, causal=causal, sm_scale=sm_scale)
    got = (o, *torch.autograd.grad(o, args, inputs[3]))
    if strided:
      for t, like in zip(got, (args[0], *args)):
        assert t.stride() == like.stride(), (label, t.stride(), like.stride())
    chunks = []
    for rows in range(0, b, TRAIN_BATCH):
      part = [t[rows:rows + TRAIN_BATCH].float() for t in inputs]
      ref_args = [t.clone().requires_grad_() for t in part[:3]]
      o_ref = fa.flash_attention_plain(*ref_args, causal=causal,
                                       sm_scale=sm_scale)
      chunks.append((o_ref.detach(),
                     *torch.autograd.grad(o_ref, ref_args, part[3])))
    want = [torch.cat(parts) for parts in zip(*chunks)]
    del chunks
    torch.cuda.synchronize()
    for key, g, w in zip(('o', 'dq', 'dk', 'dv'), got, want):
      assert g.dtype == dtype and torch.isfinite(g).all(), (key, name, label)
      g, w = g.detach().float(), w.detach()
      err = float((g - w).abs().max())
      record = errors[name].setdefault(label, {})
      record[key] = dict(max_abs=err)
      if dtype == torch.float32 and key == 'o':
        assert err <= FLASH_ATOL_F32, (label, key, err)
      elif dtype == torch.float32:
        excess = float(((g - w).abs()
                        - FLASH_GRAD_TOL_F32 * (1 + w.abs())).max())
        assert excess <= 0, (label, key, err)
      else:
        rel = tile_rel_err(g, w)
        record[key]['tile_rel'] = rel
        assert rel <= FLASH_TOL_BF16, (label, key, rel)


def phase_flash(torch):
  """Kernel C against its plain version on the card, then timed at the
  training shapes in bf16 beside its bounds, the plain version and
  scaled_dot_product_attention (the yardstick, never used by the port)."""
  import torch.nn.functional as F
  from mt3_tpu_torch.ops import flash_attention as fa

  dev = torch.device(DEVICE)
  gen = torch.Generator(device=dev).manual_seed(1)
  b, h, d = TRAIN_BATCH, 6, 64
  errors = {'float32': {}, 'bfloat16': {}}
  for lq, lk, causal in FLASH_SHAPES:
    _flash_check(torch, fa, gen, errors, lq, lk, causal)
  for case in FLASH_CHECKS:
    _flash_check(torch, fa, gen, errors, **case)
  for name, by_call in errors.items():
    for label, record in by_call.items():
      log(f'kernel C {name} {label}: ' + ', '.join(
          f'{key} max abs {r["max_abs"]:.3e}'
          + (f' block rel {r["tile_rel"]:.3e}' if 'tile_rel' in r else '')
          for key, r in record.items()))
  log(f'kernel C limits: float32 atol {FLASH_ATOL_F32} on o, '
      f'{FLASH_GRAD_TOL_F32} x (1 + |w|) on grads; bf16 block relative '
      f'{FLASH_TOL_BF16} against float32 on the rounded inputs')

  timings = []
  for lq, lk, causal in FLASH_SHAPES:
    qb, kb, vb, dob = (
        (torch.randn(b, h, length, d, device=dev, generator=gen) * scale
         ).to(torch.bfloat16)
        for length, scale in ((lq, d ** -0.5), (lk, 1.0), (lk, 1.0),
                              (lq, 0.5)))
    o, lse = fa._launch_fwd(qb, kb, vb, causal, 1.0)
    _, di = fa._launch_dq(qb, kb, vb, o, dob, lse, causal, 1.0)
    kernel_ms = {
        'fwd': graph_ms(torch, lambda: fa._launch_fwd(
            qb, kb, vb, causal, 1.0), 20),
        'dq': graph_ms(torch, lambda: fa._launch_dq(
            qb, kb, vb, o, dob, lse, causal, 1.0), 20),
        'dkv': graph_ms(torch, lambda: fa._launch_dkv(
            qb, kb, vb, dob, lse, di, causal, 1.0), 20),
    }
    leaves = [t.clone().requires_grad_() for t in (qb, kb, vb)]
    kernel_out = fa.flash_attention(*leaves, causal=causal)
    plain_out = fa.flash_attention_plain(*leaves, causal)
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              scale=1.0)

    def grad(out, wrt):
      return lambda: torch.autograd.grad(out, wrt, dob, retain_graph=True)
    other_ms = {
        # The whole backward as autograd runs it: dQ (with di), then dK/dV.
        'kernel_bwd': time_ms(torch, grad(kernel_out, leaves), 20),
        'plain_fwd': graph_ms(torch, lambda: fa.flash_attention_plain(
            qb, kb, vb, causal), 5),
        # The plain version of each backward entry point: autograd asked
        # for its outputs only.
        'plain_dkv': time_ms(torch, grad(plain_out, leaves[1:]), 5),
        'plain_dq': time_ms(torch, grad(plain_out, leaves[:1]), 5),
        'plain_bwd': time_ms(torch, grad(plain_out, leaves), 5),
        'sdpa_fwd': graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qb, kb, vb, is_causal=causal, scale=1.0), 20),
        'sdpa_bwd': time_ms(torch, grad(sdpa_out, leaves), 20),
    }
    del kernel_out, plain_out, sdpa_out, leaves
    work = _flash_work(b, h, lq, lk, d, causal, 2)
    bounds = {key: bound(f, n, PEAK_BF16_FLOPS) for key, (f, n) in work.items()}
    row = dict(lq=lq, lk=lk, causal=causal, kernel_ms=kernel_ms, **other_ms,
               bounds={k: dict(ms=v[0], by=v[1], flops=work[k][0],
                               bytes=work[k][1]) for k, v in bounds.items()})
    timings.append(row)

    def rate(key, ms):
      return f'{work[key][0] / ms / 1e9:.1f} TFLOP/s'
    log(f'kernel C [b={b}, h={h}, {lq}x{lk}, {"causal" if causal else "full"}'
        f', bf16]: fwd {kernel_ms["fwd"]:.4f} ms ({rate("fwd", kernel_ms["fwd"])}'
        f'; bound {bounds["fwd"][0]:.4f}, {bounds["fwd"][1]}; SDPA '
        f'{other_ms["sdpa_fwd"]:.4f}), dq+di {kernel_ms["dq"]:.4f} ms '
        f'({rate("dq", kernel_ms["dq"])}; bound {bounds["dq"][0]:.4f}), dkv '
        f'{kernel_ms["dkv"]:.4f} ms ({rate("dkv", kernel_ms["dkv"])}; bound '
        f'{bounds["dkv"][0]:.4f}); whole backward '
        f'{other_ms["kernel_bwd"]:.4f} ms ({rate("bwd", other_ms["kernel_bwd"])}'
        f'; bound {bounds["bwd"][0]:.4f}, {bounds["bwd"][1]}; SDPA '
        f'{other_ms["sdpa_bwd"]:.4f}); plain fwd {other_ms["plain_fwd"]:.4f} '
        f'dkv {other_ms["plain_dkv"]:.4f} dq {other_ms["plain_dq"]:.4f} bwd '
        f'{other_ms["plain_bwd"]:.4f}')
  RESULTS['flash'] = dict(errors=errors, shapes=timings)

  # One JSON entry per entry point: the sum over the three training call
  # shapes (one encoder, one decoder-self and one cross call per layer).
  def total(getter):
    return sum(getter(r) for r in timings)

  def bound_of(key):
    by_ops = total(lambda r: r['bounds'][key]['flops']) / PEAK_BF16_FLOPS
    by_bytes = total(lambda r: r['bounds'][key]['bytes']) / PEAK_BYTES_PER_S
    return (total(lambda r: r['bounds'][key]['ms']),
            'operations' if by_ops >= by_bytes else 'bytes')

  def worst(dtype, keys, field):
    return max(r[k][field] for r in errors[dtype].values() for k in keys)

  bwd_bound = bound_of('bwd')
  # dK/dV and dQ have no library call of their own: SDPA's backward
  # computes all three gradients.  It stands beside the port's whole
  # backward, bound for bound, under 'whole_backward'.
  whole_backward = dict(
      ms=total(lambda r: r['kernel_bwd']),
      kernels_ms=total(lambda r: r['kernel_ms']['dkv'] + r['kernel_ms']['dq']),
      plain_ms=total(lambda r: r['plain_bwd']),
      bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
      library_ms=total(lambda r: r['sdpa_bwd']))
  kernels = {}
  for key, name in (('fwd', 'flash_attention_fwd'),
                    ('dkv', 'flash_attention_dkv'),
                    ('dq', 'flash_attention_dq')):
    err_keys = {'fwd': ('o',), 'dkv': ('dk', 'dv'), 'dq': ('dq',)}[key]
    bound_ms, bound_by = bound_of(key)
    # Errors as in earlier runs: max_abs_err is the float32 path's (the FMA
    # kernels of source_f32), the bf16 keys the tensor-core kernels' (source).
    entry = dict(
        name=name, route='cuda',
        source='mt3_tpu_torch/csrc/flash_attention_tc.cu',
        source_f32='mt3_tpu_torch/csrc/flash_attention.cu',
        replaces=STOCK_FLASH[key],
        max_abs_err=worst('float32', err_keys, 'max_abs'),
        max_abs_err_bf16=worst('bfloat16', err_keys, 'max_abs'),
        rel_err_bf16=worst('bfloat16', err_keys, 'tile_rel'),
        ms=total(lambda r: r['kernel_ms'][key]),
        plain_ms=total(lambda r: r[f'plain_{key}']),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=(total(lambda r: r['sdpa_fwd']) if key == 'fwd' else None))
    if key != 'fwd':
      entry['whole_backward'] = whole_backward
    kernels[name] = entry
  fwd = kernels['flash_attention_fwd']
  quoted = FMA_DESIGN_QUOTED_MS
  log(f'kernel C per layer (three calls): fwd {fwd["ms"]:.4f} ms (FMA design '
      f'{quoted["fwd"]} quoted, by events; SDPA '
      f'{fwd["library_ms"]:.4f}, {fwd["ms"] / fwd["library_ms"]:.2f}x; bound '
      f'{fwd["bound_ms"]:.4f}, {fwd["bound_ms"] / fwd["ms"]:.1%}); whole '
      f'backward {whole_backward["ms"]:.4f} ms (FMA design '
      f'{quoted["bwd"]} quoted; SDPA '
      f'{whole_backward["library_ms"]:.4f}, '
      f'{whole_backward["ms"] / whole_backward["library_ms"]:.2f}x; bound '
      f'{whole_backward["bound_ms"]:.4f}, '
      f'{whole_backward["bound_ms"] / whole_backward["ms"]:.1%})')
  return kernels


# The stock Pallas TPU kernel's functions (jax 0.9.0), by entry point.
STOCK_FLASH = {
    'fwd': 'jax/experimental/pallas/ops/tpu/flash_attention.py:589',
    'dkv': 'jax/experimental/pallas/ops/tpu/flash_attention.py:941',
    'dq': 'jax/experimental/pallas/ops/tpu/flash_attention.py:1287',
}


def _mt3_trainer(torch, remat, batch_size=TRAIN_BATCH):
  """Trainer at mt3 width, bf16, flash, dropout 0.1, warmup 1 step, and one
  fixed make_train_batch batch."""
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.train import trainer as trainer_lib
  config = config_lib.mt3_config()
  model = dataclasses.replace(config.model, dtype='bfloat16',
                              train_attention_impl='flash', dropout_rate=0.1,
                              remat=remat)
  run = dataclasses.replace(config.run, warmup_steps=1)
  trainer = trainer_lib.Trainer(model, run, seed=0, device=DEVICE)
  batch = trainer_lib.make_train_batch(
      np.random.RandomState(0), batch_size, run.inputs_length,
      run.targets_length, model.input_depth, model.vocab_size)
  return trainer, batch


def _reset_launches():
  from mt3_tpu_torch.ops import decode_attention, flash_attention, logmel
  logmel.LAUNCHES = 0
  decode_attention.reset_launches()
  for key in flash_attention.LAUNCHES:
    flash_attention.LAUNCHES[key] = 0


def _launches():
  from mt3_tpu_torch.ops import decode_attention, flash_attention, logmel
  return {'logmel': logmel.LAUNCHES,
          'decode_attention': decode_attention.LAUNCHES,
          **{f'flash_attention_{k}': v
             for k, v in flash_attention.LAUNCHES.items()}}


def phase_train_parity(torch):
  """(a) One float32 train step with the kernels on the card against the
  same step through the plain path on the CPU, b=2, dropout 0."""
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.train import trainer as trainer_lib

  config = config_lib.mt3_config()
  model = dataclasses.replace(config.model, dtype='float32',
                              train_attention_impl='flash', dropout_rate=0.0)
  run = dataclasses.replace(config.run, warmup_steps=1)
  params = params_lib.init_params(model, torch.Generator().manual_seed(3))
  rng = np.random.RandomState(4)
  batches = [trainer_lib.make_train_batch(
      rng, 2, run.inputs_length, run.targets_length, model.input_depth,
      model.vocab_size) for _ in range(2)]
  for batch in batches:   # some padding, which the flash route ignores
    batch['decoder_target_tokens'][1, 700:] = 0
    batch['decoder_input_tokens'][1, 701:] = 0
    batch['decoder_loss_weights'] = (
        batch['decoder_target_tokens'] > 0).astype(np.int32)

  def run_steps(device):
    state = trainer_lib.init_train_state(model, device=device, params=params)
    before = [p.detach().clone() for p in params_lib.tree_leaves(state.params)]
    out = []
    start = time.perf_counter()
    for batch in batches:   # learning rates 0 and 1e-3
      tensors = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
      state, metrics = trainer_lib.train_step(state, tensors, 0, model, run)
      out.append({k: float(v) for k, v in metrics.items()})
    seconds = time.perf_counter() - start
    after = [p.detach().cpu() for p in params_lib.tree_leaves(state.params)]
    return out, [a - b.cpu() for a, b in zip(after, before)], seconds

  _reset_launches()
  card, card_updates, card_s = run_steps(torch.device(DEVICE))
  torch.cuda.synchronize()
  launches = _launches()
  cpu, cpu_updates, cpu_s = run_steps(torch.device('cpu'))
  worst_update = 0.0
  for g, w in zip(card_updates, cpu_updates):
    scale = float(w.abs().max())
    worst_update = max(worst_update, float((g - w).abs().max()) /
                       max(scale, 1e-30))
  log(f'phase 8a train step parity (mt3 width, float32, b=2, 2 steps): loss '
      f'card {[m["loss"] for m in card]} cpu {[m["loss"] for m in cpu]}; '
      f'grad_norm card {[m["grad_norm"] for m in card]} cpu '
      f'{[m["grad_norm"] for m in cpu]}; worst leaf update error '
      f'{worst_update:.3e} of its largest (tolerance {TRAIN_UPDATE_RTOL}); '
      f'card {card_s:.1f}s, cpu {cpu_s:.1f}s; launches {launches}')
  for c, p in zip(card, cpu):
    assert abs(c['loss'] - p['loss']) <= TRAIN_LOSS_RTOL * abs(p['loss'])
    assert abs(c['grad_norm'] - p['grad_norm']) <= (
        TRAIN_GRAD_NORM_RTOL * p['grad_norm'])
  assert worst_update <= TRAIN_UPDATE_RTOL, worst_update
  assert launches['flash_attention_fwd'] == 2 * 24, launches
  RESULTS['train_parity'] = dict(card=card, cpu=cpu,
                                 worst_update_rel=worst_update,
                                 card_s=card_s, cpu_s=cpu_s)


def phase_train(torch):
  """(b) bf16 training at mt3 width, b=64: the main training path."""
  from mt3_tpu_torch.codec import vocabulary
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.data import datasets, pipeline
  from mt3_tpu_torch.train import trainer as trainer_lib

  config = config_lib.mt3_config()
  codec = vocabulary.build_codec(config.vocab)
  run = config.run
  source = datasets.resolve_data_source('synthetic', config.spectrogram,
                                        num_examples=8, seed=0)
  raw = next(pipeline.train_batches(
      source.examples(), config.spectrogram, codec,
      vocabulary.vocabulary_from_codec(codec),
      pipeline.TrainPipelineConfig(
          inputs_length=run.inputs_length, targets_length=run.targets_length,
          batch_size=TRAIN_BATCH, seed=0)))

  trainer, batch = _mt3_trainer(torch, remat=False)
  model = trainer.model_config
  # Encoder self-attention per encoder layer; decoder self and cross per
  # decoder layer.
  per_step = model.num_encoder_layers + 2 * model.num_decoder_layers
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _reset_launches()
  losses, walls, step_launches = [], [], []
  features = trainer_lib.model_batch(raw, config.spectrogram, DEVICE)
  for step in range(6):
    before = _launches()
    start = time.perf_counter()
    metrics = trainer.step(batch if step < 5 else features)
    loss = float(metrics['loss'])   # waits for the step
    walls.append(time.perf_counter() - start)
    after = _launches()
    step_launches.append({k: after[k] - before[k] for k in after
                          if k.startswith('flash')})
    losses.append(loss)
  launches = _launches()
  peak = torch.cuda.max_memory_allocated()
  steady = walls[1:5]
  ms_step = 1e3 * sum(steady) / len(steady)
  tokens = TRAIN_BATCH * run.targets_length
  log(f'phase 8b train (mt3, bf16, flash, dropout 0.1, b={TRAIN_BATCH}): '
      f'losses {[round(l, 4) for l in losses]} (5 on the fixed batch, then '
      f'the pipeline batch); {ms_step:.1f} ms/step over steps 1-4 = '
      f'{tokens / ms_step * 1e3:.0f} target tokens/s; walls '
      f'{[round(w, 3) for w in walls]} s; peak memory {peak / 2**30:.2f} '
      f'GiB; launches {launches}')
  assert all(math.isfinite(l) for l in losses), losses
  assert losses[4] < losses[0], losses
  for counts in step_launches:
    assert counts == {'flash_attention_fwd': per_step,
                      'flash_attention_dkv': per_step,
                      'flash_attention_dq': per_step}, counts
  assert launches['logmel'] == 1, launches
  RESULTS['train'] = dict(losses=losses, walls=walls, ms_per_step=ms_step,
                          target_tokens_per_s=tokens / ms_step * 1e3,
                          peak_memory_bytes=peak, launches=launches,
                          per_step_launches=step_launches)
  del trainer, features

  trainer, batch = _mt3_trainer(torch, remat=True)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  remat_walls, remat_losses = [], []
  for _ in range(2):
    before = _launches()
    start = time.perf_counter()
    remat_losses.append(float(trainer.step(batch)['loss']))
    remat_walls.append(time.perf_counter() - start)
    after = _launches()
    counts = {k: after[k] - before[k] for k in after if k.startswith('flash')}
    assert counts == {'flash_attention_fwd': 2 * per_step,
                      'flash_attention_dkv': per_step,
                      'flash_attention_dq': per_step}, counts
  remat_peak = torch.cuda.max_memory_allocated()
  assert all(math.isfinite(l) for l in remat_losses), remat_losses
  log(f'phase 8b remat=full: losses {remat_losses}, walls '
      f'{[round(w, 3) for w in remat_walls]} s, peak memory '
      f'{remat_peak / 2**30:.2f} GiB; kernel C forward launches '
      f'{2 * per_step} per step')
  RESULTS['train_remat'] = dict(losses=remat_losses, walls=remat_walls,
                                peak_memory_bytes=remat_peak)
  return launches


def phase_train_cli():
  """(c) The training CLI: 3 steps with a checkpoint, then resume to 4."""
  ckpt = WORK_DIR / 'ckpt'
  if ckpt.exists():
    for f in ckpt.iterdir():
      f.unlink()
  common = [sys.executable, '-m', 'mt3_tpu_torch.cli.train', '--model',
            'mt3', '--data', 'synthetic', '--batch_size', '8', '--attention',
            'flash', '--bf16', '--checkpoint_dir', str(ckpt), '--log_every',
            '1']
  outputs = []
  for extra in (['--steps', '3'], ['--steps', '4', '--resume']):
    cli = subprocess.run(common + extra, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    log('train cli: ' + ' | '.join(cli.stderr.strip().splitlines()[-6:]))
    assert cli.returncode == 0, cli.stderr[-4000:]
    outputs.append(cli.stderr)
  assert 'step 2: loss=' in outputs[0], outputs[0][-2000:]
  assert 'resumed from step 3' in outputs[1], outputs[1][-2000:]
  assert 'step 3: loss=' in outputs[1] and 'step 2:' not in outputs[1]
  assert (ckpt / 'checkpoint_4.pt').exists()


# ---------------------------------------------------------------------------
# Phase 10: evaluating a trained checkpoint (checkpoint import, beam search,
# the metric family)
# ---------------------------------------------------------------------------
QUICKSTART_STEPS = 150      # examples/quickstart.py
EVAL_ONSET_F1_MIN = 0.9     # JAX's quickstart reaches 1.000 on the CPU
BEAMS = 4
BEAM_LOCKSTEP_STEPS = 128
BEAM_LOCKSTEP_BATCH = 2
BEAM_SCORE_RTOL = 1e-4
BEAM_NEAR_TIE = 1e-5        # relative gap under which a parting is a tie
BEAM_SERVE_BATCH = 8


def _quickstart(torch):
  """examples/quickstart.py's configuration and clip, trained with the
  port's Trainer on the card: emb 128, 4 heads x 16, 2+2 layers, one
  velocity bin, ties, 256 inputs, 160 targets, batch 4, lr 3e-3, warm-up
  10, 150 steps on one synthetic clip (seed 11, polyphony 1)."""
  from mt3_tpu_torch.codec import vocabulary
  from mt3_tpu_torch.core.config import (MT3Config, ModelConfig, RunConfig,
                                         SpectrogramConfig, VocabularyConfig)
  from mt3_tpu_torch.data import datasets, pipeline
  from mt3_tpu_torch.train import trainer as trainer_lib

  spec = SpectrogramConfig()
  vocab_config = VocabularyConfig(num_velocity_bins=1)
  codec = vocabulary.build_codec(vocab_config)
  vocab = vocabulary.vocabulary_from_codec(codec)
  model = ModelConfig(
      vocab_size=vocabulary.num_embeddings(vocab), emb_dim=128, num_heads=4,
      num_encoder_layers=2, num_decoder_layers=2, head_dim=16, mlp_dim=256,
      dropout_rate=0.0, input_depth=512, max_positions=512)
  run = RunConfig(inputs_length=256, targets_length=160, batch_size=4,
                  learning_rate=3e-3, warmup_steps=10, use_ties=True)
  config = MT3Config('quickstart', spec, vocab_config, model, run)
  example = next(datasets.SyntheticDataSource(
      num_examples=1, duration=2.0, seed=11, polyphony=1).examples())
  batch = next(pipeline.train_batches(
      [example], spec, codec, vocab, pipeline.TrainPipelineConfig(
          inputs_length=run.inputs_length,
          targets_length=run.targets_length, batch_size=run.batch_size)))
  trainer = trainer_lib.Trainer(model_config=model, run_config=run,
                                device=DEVICE)
  model_batch = trainer_lib.model_batch(batch, spec, DEVICE)
  start = time.perf_counter()
  losses = [float(trainer.step(model_batch)['loss'])
            for _ in range(QUICKSTART_STEPS)]
  seconds = time.perf_counter() - start
  log(f'phase 10 quickstart: {QUICKSTART_STEPS} steps in {seconds:.1f}s, '
      f'loss {losses[0]:.3f} -> {losses[-1]:.3f}')
  return config, example, trainer, dict(train_s=seconds, loss_first=losses[0],
                                        loss_last=losses[-1])


def _evaluate_trained(torch):
  """(1) The quickstart model saved, reloaded as load_transcriber reloads a
  checkpoint (latest_checkpoint -> restore_params), and scored by the
  evaluator, greedy and with beam search; kernels A and B counted."""
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.eval import evaluator
  from mt3_tpu_torch.eval import metrics as metrics_lib
  from mt3_tpu_torch.infer.transcribe import Transcriber
  from mt3_tpu_torch.train import checkpoint as ckpt_lib

  config, example, trainer, result = _quickstart(torch)
  directory = WORK_DIR / 'quickstart'
  for old in directory.glob('checkpoint_*'):
    old.unlink()
  saved = ckpt_lib.save_checkpoint(str(directory), trainer.state)
  assert ckpt_lib.latest_checkpoint(str(directory)) == saved
  params, path = ckpt_lib.load_params(str(directory), config.model)
  for got, want in zip(params_lib.tree_leaves(params),
                       params_lib.tree_leaves(trainer.state.params)):
    assert torch.equal(got, want.detach().cpu())
  scores = {}
  score_fn = metrics_lib.transcription_metrics
  metric_s = []

  def timed_metrics(*args, **kwargs):   # the metric family, on the host
    start = time.perf_counter()
    out = score_fn(*args, **kwargs)
    metric_s.append(time.perf_counter() - start)
    return out

  metrics_lib.transcription_metrics = timed_metrics
  try:
    for num_beams in (0, BEAMS):
      transcriber = Transcriber(config, params, num_beams=num_beams,
                                device=DEVICE)
      _reset_launches()
      start = time.perf_counter()
      s = evaluator.evaluate_dataset([example], transcriber)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - start
      counts = _variant_launches()
      label = 'greedy' if num_beams == 0 else f'beam {num_beams}'
      log(f'phase 10 trained model from {pathlib.Path(path).name}, {label}: '
          f'onset F1 {s["Onset F1"]:.4f}, onset+offset F1 '
          f'{s["Onset + offset F1"]:.4f}, frame F1 {s["Frame F1"]:.4f} '
          f'({seconds:.3f}s, of which the host metrics {metric_s[-1]:.3f}s;'
          f' launches {counts})')
      assert counts['logmel'] > 0 and counts['decode_attention_mha'] > 0, (
          counts)
      assert s['Onset F1'] >= EVAL_ONSET_F1_MIN, (label, s['Onset F1'])
      scores[label] = dict(onset_f1=s['Onset F1'],
                           onset_offset_f1=s['Onset + offset F1'],
                           frame_f1=s['Frame F1'], seconds=seconds,
                           metrics_s=metric_s[-1], launches=counts)
  finally:
    metrics_lib.transcription_metrics = score_fn
  return dict(result, checkpoint=path, scores=scores)


def _variant_launches():
  from mt3_tpu_torch.ops import decode_attention, logmel
  return {'logmel': logmel.LAUNCHES,
          **{f'decode_attention_{k}': v
             for k, v in decode_attention.VARIANT_LAUNCHES.items()}}


def _beam_against_plain(torch):
  """(2) Beam search at mt3 width, float32, MHA caches, b=2 x 4 beams,
  128 steps, on the card (kernel B) and through the plain path on the CPU
  from the card's encoder output.  Every top-k of the card's run is
  recorded; the CPU's run computes its own at each call, reports where it
  parts from the card's (the step and both candidates' scores), then takes
  the card's choice, so one parting does not carry into the next steps.
  A parting whose candidates lie within BEAM_NEAR_TIE relative is a near
  tie; one is allowed, any other parting fails.  Final scores within
  BEAM_SCORE_RTOL relative."""
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.infer import beam_search as bs
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.ops import decode_attention, spectrogram

  config, model, params, frames = _forced_setup(torch, {})
  frames = frames[:BEAM_LOCKSTEP_BATCH]
  p_k = params_lib.to_device(params, DEVICE)
  with torch.inference_mode():
    mel = spectrogram.compute_logmel(
        spectrogram.flatten_frames(frames.to(DEVICE)), config.spectrogram)
    encoded = t5.encode(p_k, model, mel)
  top_k = bs.top_k
  records = []

  def recording(x, k):
    values, indices = top_k(x, k)
    records.append((x.cpu(), indices.cpu()))
    return values, indices

  bs.top_k = recording
  decode_attention.reset_launches()
  try:
    start = time.perf_counter()
    with torch.inference_mode():
      tokens_k, scores_k = bs.beam_search(p_k, model, encoded,
                                          BEAM_LOCKSTEP_STEPS,
                                          num_beams=BEAMS)
    tokens_k, scores_k = tokens_k.cpu(), scores_k.cpu()
    card_s = time.perf_counter() - start
  finally:
    bs.top_k = top_k
  launches = dict(decode_attention.VARIANT_LAUNCHES)

  partings, calls = [], [0]

  def forced(x, k):
    i = calls[0]
    calls[0] += 1
    x_k, idx_k = records[i]
    _, idx_p = top_k(x, k)
    if not torch.equal(idx_p, idx_k):
      row, pos = (int(v) for v in (idx_p != idx_k).nonzero()[0])
      card_pick, plain_pick = int(idx_k[row, pos]), int(idx_p[row, pos])
      plain = (float(x[row, card_pick]), float(x[row, plain_pick]))
      partings.append(dict(
          step=i // 3, top_k_call=i % 3, row=row, position=pos,
          card_pick=card_pick, plain_pick=plain_pick, plain_scores=plain,
          card_scores=(float(x_k[row, card_pick]),
                       float(x_k[row, plain_pick])),
          rel_gap=abs(plain[0] - plain[1]) / max(abs(plain[1]), 1e-30)))
      log(f'phase 10 beam lockstep: parting at step {i // 3} (top-k call '
          f'{i % 3}), row {row}, position {pos}: card {card_pick} vs plain '
          f'{plain_pick}; {partings[-1]}')
    return torch.gather(x, -1, idx_k), idx_k

  bs.top_k = forced
  try:
    start = time.perf_counter()
    with torch.inference_mode():
      tokens_p, scores_p = bs.beam_search(params, model, encoded.cpu(),
                                          BEAM_LOCKSTEP_STEPS,
                                          num_beams=BEAMS)
    cpu_s = time.perf_counter() - start
  finally:
    bs.top_k = top_k
  assert calls[0] == len(records), (calls[0], len(records))
  score_err = float(((scores_k - scores_p) / scores_p).abs().max())
  near_ties = [p for p in partings if p['rel_gap'] < BEAM_NEAR_TIE]
  rows = BEAM_LOCKSTEP_BATCH * BEAMS
  log(f'phase 10 beam lockstep (mt3, float32, MHA, b={BEAM_LOCKSTEP_BATCH} x '
      f'{BEAMS} beams, {BEAM_LOCKSTEP_STEPS} steps): {len(records)} top-k '
      f'calls, partings {len(partings)} (near ties {len(near_ties)}); scores '
      f'card {scores_k.tolist()} plain {scores_p.tolist()}, max rel err '
      f'{score_err:.3e} (rtol {BEAM_SCORE_RTOL}); kernel B launches '
      f'{launches} at {rows} rows; card {card_s:.1f}s, cpu {cpu_s:.1f}s')
  assert torch.equal(tokens_k, tokens_p)
  assert len(partings) == len(near_ties) <= 1, partings
  assert score_err <= BEAM_SCORE_RTOL, score_err
  assert launches == {'mha': model.num_decoder_layers * BEAM_LOCKSTEP_STEPS}
  return dict(top_k_calls=len(records), partings=partings,
              score_rel_err=score_err, launches=launches,
              tokens_eos=int((tokens_k == 1).sum()))


def _beam_serve(torch, label, config, params, frames):
  """(3) One batch of segments through log-mel, the encoder and, in turn,
  greedy decoding and beam search: audio-s/s, ms per step, peak memory and
  kernel B launches of each, after a 32-step warm-up of each; then each
  mode's 32-step run under the profiler (device time by kind, idle
  share)."""
  from mt3_tpu_torch.infer import beam_search as bs
  from mt3_tpu_torch.infer import decode
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.ops import decode_attention, logmel, spectrogram

  model = config.model
  max_len = config.run.targets_length
  audio_s = (frames.shape[0] * config.run.inputs_length
             / config.spectrogram.frames_per_second)

  def run(mode, length):
    with torch.inference_mode():
      mel = spectrogram.compute_logmel(spectrogram.flatten_frames(frames),
                                       config.spectrogram)
      encoded = t5.encode(params, model, mel)
      if mode == 'greedy':
        tokens, _ = decode.decode_tokens(
            params, model, encoded, length,
            steps_per_iter=model.decode_steps_per_iter)
      else:
        tokens, _ = bs.beam_search(params, model, encoded, length,
                                   num_beams=BEAMS,
                                   steps_per_iter=model.decode_steps_per_iter)
      return tokens.cpu()

  out = {}
  for mode in ('greedy', 'beam'):
    run(mode, 32)
    steps = [0]
    decode_step = t5.decode_step

    def counted(*args, **kwargs):
      steps[0] += 1
      return decode_step(*args, **kwargs)

    t5.decode_step = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode_attention.reset_launches()
    logmel.LAUNCHES = 0
    try:
      start = time.perf_counter()
      tokens = run(mode, max_len)
      wall = time.perf_counter() - start
    finally:
      t5.decode_step = decode_step
    peak = torch.cuda.max_memory_allocated()
    launches = dict(decode_attention.VARIANT_LAUNCHES)
    rows = frames.shape[0] * (BEAMS if mode == 'beam' else 1)
    assert tokens.shape == (frames.shape[0], max_len)
    assert int(tokens.min()) >= 0 and int(tokens.max()) < model.vocab_size
    assert logmel.LAUNCHES == 1
    assert sum(launches.values()) == model.num_decoder_layers * steps[0]
    out[mode] = dict(audio_s=audio_s, wall_s=wall,
                     audio_s_per_s=audio_s / wall, steps=steps[0],
                     ms_per_step=wall / steps[0] * 1e3, rows=rows,
                     peak_memory_bytes=peak, decode_attention_launches=launches)
    log(f'phase 10 beam serving {label}, {mode} ({rows} rows): '
        f'{audio_s:.3f} audio-s in {wall:.3f}s = {audio_s / wall:.3f} '
        f'audio-s/s; {steps[0]} steps, {wall / steps[0] * 1e3:.3f} ms per '
        f'step; peak memory {peak / 2**20:.1f} MiB; kernel B launches '
        f'{launches}')
    out[mode]['profile'] = _profile(
        torch, lambda: run(mode, 32),
        f'phase 10 {label} {mode}: log-mel, encoder, 32 decode steps, '
        f'{rows} rows')
  return out


def _evaluate_clis(torch):
  """(4) The evaluate CLI on a checkpoint of the tiny preset, then the
  transcribe CLI with --num_beams 4 from the same checkpoint."""
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.train import trainer as trainer_lib

  tiny = config_lib.tiny_config()
  directory = WORK_DIR / 'tiny_ckpt'
  for old in directory.glob('checkpoint_*'):
    old.unlink()
  trainer_lib.Trainer(tiny.model, tiny.run, device=DEVICE).save(
      str(directory))
  output = WORK_DIR / 'evaluate.json'
  if output.exists():
    output.unlink()
  cli = subprocess.run(
      [sys.executable, '-m', 'mt3_tpu_torch.cli.evaluate', '--model', 'tiny',
       '--data', 'synthetic', '--num_examples', '2', '--checkpoint',
       str(directory), '--output', str(output)],
      cwd=ROOT, capture_output=True, text=True, timeout=600)
  log('evaluate cli: ' + ' | '.join(cli.stderr.strip().splitlines()[-3:]))
  assert cli.returncode == 0, cli.stderr[-4000:]
  record = json.loads(output.read_text())
  assert all(math.isfinite(v) for v in record.values()), record
  assert 'Onset F1' in record and 'Frame F1' in record
  midi = WORK_DIR / 'beam' / 'clip.mid'
  if midi.exists():
    midi.unlink()
  cli = subprocess.run(
      [sys.executable, '-m', 'mt3_tpu_torch.cli.transcribe',
       str(WORK_DIR / 'clip.wav'), '--model', 'tiny', '--checkpoint',
       str(directory), '--num_beams', str(BEAMS), '--output_dir',
       str(WORK_DIR / 'beam')],
      cwd=ROOT, capture_output=True, text=True, timeout=600)
  log('transcribe cli --num_beams: ' + (cli.stdout.strip()
                                        or cli.stderr.strip()[-2000:]))
  assert cli.returncode == 0, cli.stderr[-4000:]
  assert midi.exists()
  return dict(evaluate=record)


def phase_evaluate(torch):
  """Phase 10: a trained model evaluated after a checkpoint round trip,
  greedy and beam 4; beam search against the plain path; beam serving at
  mt3 width in two cache configurations; the evaluate and transcribe CLIs."""
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.core import config as config_lib

  WORK_DIR.mkdir(parents=True, exist_ok=True)
  result = {'trained': _evaluate_trained(torch),
            'lockstep': _beam_against_plain(torch)}
  base = config_lib.mt3_config()
  frames = _bench_frames(torch, base)[:BEAM_SERVE_BATCH]
  launches = {}
  for label, overrides in (('mha_bf16', {}), ('production', PRODUCTION)):
    config = dataclasses.replace(base, model=dataclasses.replace(
        base.model, dtype='bfloat16', **overrides))
    params = params_lib.init_params(config.model, device=DEVICE)
    result[f'serve_{label}'] = served = _beam_serve(torch, label, config,
                                                    params, frames)
    for mode in ('greedy', 'beam'):
      for variant, n in served[mode]['decode_attention_launches'].items():
        launches[f'decode_attention_{variant}_{mode}'] = n
    del params
    torch.cuda.empty_cache()
  if not (WORK_DIR / 'clip.wav').exists():
    _write_wav(WORK_DIR / 'clip.wav', chord_clip(4.0, seed=10))
  result.update(_evaluate_clis(torch))
  result['launches'] = launches
  log(f'phase 10 kernel B launches by variant and decoder: {launches}')
  RESULTS['evaluate'] = result


# ---------------------------------------------------------------------------
# Phase 11: the flagship training recipe from a corpus on disk
# (tools/run_flagship.sh: segment cache, held-out wav+MIDI evaluation,
# TensorBoard logs, asynchronous checkpoints)
# ---------------------------------------------------------------------------
DATA_MODEL = 'mt3'           # full width and depth
DATA_CLIPS = 64              # polysynth clips of 8.192 s
DATA_SEED = 1000             # tools/run_flagship.sh: polysynth:16384:1000
DATA_EVAL_SEED = DATA_SEED + 9_000_000   # tools/make_corpus.py's validation
DATA_EVAL_CLIPS = 4
DATA_SLAKH_RECORDS = 4
DATA_CLIP_S = 8.192
DATA_BATCH = 256             # tools/run_flagship.sh
DATA_TIMED_BATCHES = 16
DATA_PY_RECORDS = 16         # records the Python reader is timed over
_DATA_LINE = re.compile(
    r'data: (\d+) batches staged for (\d+) steps; the step loop waited '
    r'([0-9.]+) ms a step on the prefetch queue of ([0-9.]+) ms a step '
    r'\(evaluation, ([0-9.]+)s, excluded\)')


def _fresh_dir(path):
  if path.exists():
    shutil.rmtree(path)
  path.mkdir(parents=True)
  return path


def _flagship_config():
  """The recipe's model: mt3 at full width and depth, remat, bf16, flash."""
  from mt3_tpu_torch.core import config as config_lib
  config = config_lib.CONFIG_FACTORIES[DATA_MODEL]()
  return dataclasses.replace(config, model=dataclasses.replace(
      config.model, remat=True, train_attention_impl='flash',
      dtype='bfloat16'))


def _write_corpus(root):
  """(b) The held-out validation directory (wav+MIDI pairs, as
  tools/make_corpus.py writes them) and a Slakh-schema TFRecord
  (mix_tracks: a float mix and one NoteSequence proto per instrument),
  both made with the port's modules.  The training clips are made by the
  train CLI itself (--data polysynth:64:1000)."""
  from mt3_tpu_torch.core import midi_io, noteseq_proto
  from mt3_tpu_torch.core.note_sequence import NoteSequence
  from mt3_tpu_torch.data import datasets, program_maps, synth, tfrecord

  validation = _fresh_dir(root / 'validation')
  source = synth.PolyphonicSynthDataSource(
      num_examples=DATA_EVAL_CLIPS, duration=DATA_CLIP_S,
      seed=DATA_EVAL_SEED, max_instruments=4)
  for i in range(len(source)):
    example = source.example(i)
    _write_wav(validation / f'clip-{i:04d}.wav', example['audio'])
    midi_io.note_sequence_to_midi_file(
        example['sequence'], str(validation / f'clip-{i:04d}.mid'))

  slakh_name = {p: n for n, p in program_maps._SLAKH_CLASS_PROGRAMS.items()}
  records, notes = [], []
  for i in range(DATA_SLAKH_RECORDS):
    ns = synth.compose_example(DATA_SEED + 5_000_000 + i, DATA_CLIP_S,
                               max_instruments=4)
    tracks = {}
    for note in ns.notes:
      name = 'Drums' if note.is_drum else slakh_name[note.program]
      tracks.setdefault(name, NoteSequence(total_time=ns.total_time)
                        ).notes.append(dataclasses.replace(note))
    records.append(tfrecord.make_example({
        'mix': synth.render_note_sequence(ns, DATA_CLIP_S, seed=i),
        'audio_sample_rate': np.array([16000], np.int64),
        'note_sequences': [noteseq_proto.notesequence_to_bytes(t)
                           for t in tracks.values()],
        'inst_names': [name.encode() for name in tracks],
        'track_id': f'Track{i:05d}'.encode()}))
    notes.append(len(ns.notes))
  slakh = root / 'slakh.tfrecord'
  tfrecord.write_records(str(slakh), records)
  read = list(datasets.ReferenceTFRecordDataSource(
      datasets.SLAKH_CONFIG, str(slakh), is_training=True).examples())
  assert [len(ex['sequence'].notes) for ex in read] == notes, notes
  assert all(ex['audio'].shape == (int(DATA_CLIP_S * 16000),) for ex in read)
  return validation, slakh


def _native_reader(records_path, cache_dir):
  """(a) The native reader against the Python one, byte for byte, on records
  written by the port's writer, on the corpus's NoteSequences, then both
  timed over the cache's records."""
  from mt3_tpu_torch.core import noteseq_proto
  from mt3_tpu_torch.data import synth, tfrecord

  assert tfrecord.native_available(), tfrecord.native_status()
  rng = np.random.RandomState(0)
  records = [tfrecord.make_example({
      'audio': rng.randn(int(rng.randint(1, 50000))).astype(np.float32),
      'ints': rng.randint(-2**40, 2**40, size=9).astype(np.int64),
      'names': [bytes(rng.randint(0, 256, size=n).astype(np.uint8))
                for n in (0, 7, 1000)]}) for _ in range(8)]
  tfrecord.write_records(str(records_path), records)
  assert list(tfrecord.read_records(str(records_path))) == records
  assert list(tfrecord._read_records_py(str(records_path), True)) == records

  def canonical(features):
    return {k: ([bytes(x) for x in v] if isinstance(v, list)
                else (str(v.dtype), v.tobytes()))
            for k, v in features.items()}

  for record in records:
    assert canonical(tfrecord.parse_example(record)) == canonical(
        tfrecord._parse_example_py(record))
  lib = tfrecord._load_library()
  for i in range(8):
    data = noteseq_proto.notesequence_to_bytes(synth.compose_example(
        DATA_SEED + i, DATA_CLIP_S, max_instruments=4))
    native = noteseq_proto._notesequence_from_bytes_native(lib, data)
    python = noteseq_proto._notesequence_from_bytes_py(data)
    assert dataclasses.asdict(native) == dataclasses.asdict(python)
    assert noteseq_proto.notesequence_to_bytes(native) == data

  shards = sorted(str(p) for p in cache_dir.glob('cache-*.tfrecord'))
  start = time.perf_counter()
  n_native = nbytes = 0
  for shard in shards:
    for record in tfrecord.read_records(shard):
      tfrecord.parse_example(record)
      n_native += 1
      nbytes += len(record)
  native_s = time.perf_counter() - start
  start = time.perf_counter()
  n_python = 0
  for record in tfrecord._read_records_py(shards[0], True):
    tfrecord._parse_example_py(record)
    n_python += 1
    if n_python == DATA_PY_RECORDS:
      break
  python_s = time.perf_counter() - start
  out = dict(status=tfrecord.native_status(), records=n_native,
             mb=nbytes / 1e6,
             native_records_per_s=n_native / native_s,
             python_records_per_s=n_python / python_s)
  log(f'phase 11 (a) {out["status"]}: native and Python readers agree on 8 '
      f'written records and 8 NoteSequences; read+parse of the cache '
      f'({n_native} records, {out["mb"]:.1f} MB): native '
      f'{out["native_records_per_s"]:.1f} records/s, Python '
      f'{out["python_records_per_s"]:.2f} records/s (over {n_python})')
  return out


def _train_cli(torch, argv):
  """The train CLI in this process (its launches are counted here)."""
  import contextlib
  import io
  from mt3_tpu_torch.cli import train as cli
  _reset_launches()
  err = io.StringIO()
  start = time.perf_counter()
  try:
    with contextlib.redirect_stderr(err):
      cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
  finally:
    text = err.getvalue()
    log('train cli ' + ' '.join(str(a) for a in argv[2:4]) + ': ' + ' | '.join(
        l for l in text.splitlines()
        if not l.startswith('{'))[-3000:])
  seconds = time.perf_counter() - start
  match = _DATA_LINE.search(text)
  assert match, text[-3000:]
  staged, steps = int(match.group(1)), int(match.group(2))
  losses = [float(x) for x in re.findall(r'loss=([-0-9.naif]+)', text)]
  assert len(losses) == steps and all(math.isfinite(l) for l in losses), text
  torch.cuda.empty_cache()
  return dict(text=text, launches=_launches(), seconds=seconds,
              staged=staged, steps=steps, wait_ms=float(match.group(3)),
              ms_per_step=float(match.group(4)),
              eval_s=float(match.group(5)), losses=losses)


def _event_scalars(log_dir):
  """(tag, step) of every scalar in the event files of log_dir."""
  from mt3_tpu_torch.utils import events
  return [event for path in log_dir.glob('events.out.tfevents.*')
          for event in events.scalar_events(path)]


def _check_launches(run, model, eval_batches=0):
  """A once a staged batch and once an evaluation segment batch; C's
  forward twice a layer a step (remat recomputes it in the backward) and
  once an encoder layer an evaluation batch, its backward once."""
  per_step = model.num_encoder_layers + 2 * model.num_decoder_layers
  counts = run['launches']
  assert counts['logmel'] == run['staged'] + eval_batches, (counts, run)
  assert counts['flash_attention_fwd'] == (
      2 * per_step * run['steps'] + model.num_encoder_layers * eval_batches
  ), counts
  assert counts['flash_attention_dkv'] == per_step * run['steps'], counts
  assert counts['flash_attention_dq'] == per_step * run['steps'], counts
  if eval_batches:
    assert counts['decode_attention'] > 0, counts
    assert counts['decode_attention'] % model.num_decoder_layers == 0
  else:
    assert counts['decode_attention'] == 0, counts


def _pipe_cfg(config):
  """The train CLI's pipeline settings at the recipe's batch."""
  from mt3_tpu_torch.data import pipeline
  run = config.run
  return pipeline.TrainPipelineConfig(
      inputs_length=run.inputs_length, targets_length=run.targets_length,
      batch_size=DATA_BATCH, onsets_only=run.onsets_only,
      include_ties=run.use_ties, program_granularity=run.program_granularity,
      max_examples_per_mix=run.max_examples_per_mix, seed=0)


def _path_checks(torch, config, cache_dir, validation):
  """Each kernel against its plain version at the shapes phase 11's runs
  give it (launches here are not counted): A on a b=256 batch read from
  the cache and on an evaluation segment batch; C in the model's dtype at
  b=256 on the recipe's three attention shapes, with q, k and v passed
  transposed as layers.attention passes them, and on the evaluation's
  encoder batch; B at the evaluation's rows and cache length in the
  model's dtype, at the split boundaries and the cache's last position."""
  from mt3_tpu_torch.codec import vocabulary
  from mt3_tpu_torch.data import datasets, pipeline
  from mt3_tpu_torch.infer import transcribe
  from mt3_tpu_torch.ops import decode_attention
  from mt3_tpu_torch.ops import flash_attention as fa

  model, run = config.model, config.run
  dtype = getattr(torch, model.dtype)
  assert (model.num_heads, model.head_dim) == (6, 64), model
  codec = vocabulary.build_codec(config.vocab)
  batch = next(pipeline.train_batches_from_cache(
      str(cache_dir), codec, vocabulary.vocabulary_from_codec(codec),
      _pipe_cfg(config), preload=False))
  example = next(iter(datasets.LocalPairsDataSource(str(validation))
                      .examples()))
  segments = transcribe.audio_to_segments(example['audio'], config)[0]
  rows = segments.frames.shape[0]
  assert rows == run.infer_batch_size, rows
  out = {'logmel': {}, 'flash': {'float32': {}, 'bfloat16': {}},
         'decode_attention': {}}
  for label, frames in (('a batch from the cache',
                         batch['encoder_input_frames']),
                        ('an evaluation segment batch', segments.frames)):
    audio = np.ascontiguousarray(frames.reshape(frames.shape[0], -1),
                                 np.float32)
    label = f'{audio.shape[0]}x{audio.shape[1]}, {label}'
    out['logmel'][label] = _logmel_check(torch, audio, label,
                                         float64_atol=None)
  del batch

  gen = torch.Generator(device=DEVICE).manual_seed(11)
  shapes = [(DATA_BATCH, run.inputs_length, run.inputs_length, False),
            (DATA_BATCH, run.targets_length, run.targets_length, True),
            (DATA_BATCH, run.targets_length, run.inputs_length, False),
            (rows, run.inputs_length, run.inputs_length, False)]
  for b, lq, lk, causal in shapes:
    _flash_check(torch, fa, gen, out['flash'], lq, lk, causal, strided=True,
                 batch=b, dtypes=(dtype,))
    torch.cuda.empty_cache()
  worst = {key: max(r[key].get('tile_rel', r[key]['max_abs'])
                    for r in out['flash'][model.dtype].values())
           for key in ('o', 'dq', 'dk', 'dv')}
  log(f'kernel C at phase 11\'s shapes ({model.dtype}, q/k/v transposed '
      f'views; b={DATA_BATCH}: {run.inputs_length}x{run.inputs_length}, '
      f'{run.targets_length}x{run.targets_length} causal, '
      f'{run.targets_length}x{run.inputs_length}; b={rows}: the evaluation\'s '
      f'encoder): worst tile_rel_err {worst} (limit {FLASH_TOL_BF16})')

  split, length = decode_attention.L_SPLIT, run.targets_length
  for index in sorted({0, split - 1, split, 2 * split, length // 2 - 1,
                       length - 1}):
    q = torch.randn(rows, model.num_heads, model.head_dim, device=DEVICE,
                    generator=gen) / 8
    nk, nv = (torch.randn(rows, model.num_heads, model.head_dim,
                          device=DEVICE, generator=gen) for _ in range(2))
    ck, cv = (torch.randn(rows, model.num_heads, model.head_dim, length,
                          device=DEVICE, generator=gen) for _ in range(2))
    q, nk, nv, ck, cv = (t.to(dtype) for t in (q, nk, nv, ck, cv))
    idx = torch.tensor(index, dtype=torch.int32, device=DEVICE)
    k1, v1 = ck.clone(), cv.clone()
    got = decode_attention.decode_attention_inplace(q, nk, nv, k1, v1, idx)
    want, plain_caches = _variant_plain(torch, [q, nk, nv, ck, cv, None,
                                                None], idx)
    torch.cuda.synchronize()
    out['decode_attention'][index] = _check_variant(
        torch, got, want, (k1, v1), plain_caches, (ck, cv), index, dtype,
        ('phase 11 evaluation', rows, index))
  log(f'kernel B at the evaluation\'s shape (b={rows}, h={model.num_heads}, '
      f'd={model.head_dim}, len={length}, {model.dtype}) at indices '
      f'{sorted(out["decode_attention"])}: max_abs_err '
      f'{max(out["decode_attention"].values()):.3e} (tolerance '
      f'{ATTN_TOL_BF16} x (1 + |out|)); caches equal to the plain write')
  return out


def _host_cost(torch, cache_dir, config):
  """(d) batches/s out of the cache (preloaded and read shard by shard) at
  b=256, then one recipe step fed from the cache under the profiler.  The
  64-segment cache is smaller than one batch: its single shard is read
  from the page cache and the 1024-entry shuffle buffer never fills, so
  the shard rate is that of the decode and crop alone."""
  from mt3_tpu_torch.codec import vocabulary
  from mt3_tpu_torch.data import pipeline
  from mt3_tpu_torch.train import trainer as trainer_lib
  codec = vocabulary.build_codec(config.vocab)
  vocab = vocabulary.vocabulary_from_codec(codec)
  run = config.run
  pipe_cfg = _pipe_cfg(config)
  out = {}
  for label, preload in (('preload', True), ('shards', False)):
    start = time.perf_counter()
    batches = pipeline.train_batches_from_cache(str(cache_dir), codec, vocab,
                                                pipe_cfg, preload=preload)
    next(batches)
    first_s = time.perf_counter() - start
    start = time.perf_counter()
    for _ in range(DATA_TIMED_BATCHES):
      batch = next(batches)
    per_batch = (time.perf_counter() - start) / DATA_TIMED_BATCHES
    assert batch['encoder_input_frames'].shape == (
        DATA_BATCH, run.inputs_length, config.spectrogram.hop_width)
    out[label] = dict(first_batch_s=first_s, s_per_batch=per_batch,
                      batches_per_s=1 / per_batch)
  log(f'phase 11 (d) train_batches_from_cache at b={DATA_BATCH}, '
      f'{DATA_TIMED_BATCHES} batches each: preloaded '
      f'{out["preload"]["batches_per_s"]:.2f} batches/s (first batch, with '
      f'the preload, {out["preload"]["first_batch_s"]:.2f}s); shard read '
      f'{out["shards"]["batches_per_s"]:.2f} batches/s')

  trainer = trainer_lib.Trainer(config.model, run, device=DEVICE)
  staged = trainer_lib.StagedBatches(
      pipeline.train_batches_from_cache(str(cache_dir), codec, vocab,
                                        pipe_cfg, preload=True),
      config.spectrogram, DEVICE)
  losses = []

  def step():
    losses.append(float(trainer.step(next(staged))['loss']))

  try:
    out['profile'] = _profile(
        torch, step, f'phase 11: one recipe step (mt3, b={DATA_BATCH}, '
        'remat, bf16 flash) fed from the preloaded cache through prefetch')
  finally:
    staged.close()
  assert all(math.isfinite(l) for l in losses), losses
  del trainer
  torch.cuda.empty_cache()
  return out


def phase_data(torch):
  """Phase 11: the flagship recipe through the port on the card, at mt3
  width and batch 256, from a segment cache read by the native reader."""
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.data import datasets
  from mt3_tpu_torch.infer import transcribe
  from mt3_tpu_torch.train import checkpoint as ckpt_lib
  from mt3_tpu_torch.train import trainer as trainer_lib

  root = _fresh_dir(WORK_DIR / 'data')
  config = _flagship_config()
  model = config.model
  validation, slakh = _write_corpus(root)
  eval_batches = sum(
      len(transcribe.audio_to_segments(ex['audio'], config))
      for ex in datasets.LocalPairsDataSource(str(validation)).examples())
  cache, ckpt, logs = root / 'cache', root / 'ckpt', root / 'logs'
  recipe = ['--model', DATA_MODEL,
            '--data', f'polysynth:{DATA_CLIPS}:{DATA_SEED}',
            '--cache_dir', cache, '--eval_data', validation,
            '--eval_examples', DATA_EVAL_CLIPS, '--eval_period', 6,
            '--batch_size', DATA_BATCH, '--remat', '--attention', 'flash',
            '--bf16', '--checkpoint_dir', ckpt, '--checkpoint_period', 3,
            '--log_dir', logs, '--log_every', 1, '--device', DEVICE]

  # (c) 6 steps with the cache built and preloaded, evaluation at step 6.
  first = _train_cli(torch, recipe + ['--steps', 6, '--preload_cache'])
  text = first['text']
  assert 'TFRecord reader: native (libmt3_native-' in text, text[-3000:]
  built = re.search(r'built segment cache: (\d+) segments -> \S+ in '
                    r'([0-9.]+)s', text)
  assert built and int(built.group(1)) == DATA_CLIPS, text[-3000:]
  assert 'eval@6: onset F1 = ' in text, text[-3000:]
  _check_launches(first, model, eval_batches)
  assert sorted(p.name for p in ckpt.iterdir()) == [
      'checkpoint_3.pt', 'checkpoint_6.pt']
  state = trainer_lib.init_train_state(model, device=DEVICE)
  ckpt_lib.restore_checkpoint(str(ckpt / 'checkpoint_3.pt'), state)
  assert state.step == 3
  del state
  scalars = _event_scalars(logs)
  assert sorted({s for t, s in scalars if t == 'train/loss'}) == list(
      range(6)), scalars
  assert {s for t, s in scalars if t == 'eval/Onset F1'} == {6}, scalars
  (record,) = [json.loads(l) for l in
               (logs / 'metrics.jsonl').read_text().splitlines()]
  assert record['step'] == 6 and all(
      math.isfinite(v) for v in record.values()), record

  # (a) The native reader, against the Python one and timed, on the cache.
  reader = _native_reader(root / 'records.tfrecord', cache)

  # Resumed to step 8 from the asynchronous checkpoint at 6, the cache
  # read shard by shard.
  resumed = _train_cli(torch, recipe + ['--steps', 8, '--resume'])
  text = resumed['text']
  assert 'built segment cache' not in text and 'resumed from step 6' in text
  assert 'step 6: loss=' in text and 'step 7: loss=' in text
  assert 'step 5:' not in text and resumed['steps'] == 2
  assert (ckpt / 'checkpoint_8.pt').exists()
  _check_launches(resumed, model)

  # Two steps on the Slakh-schema TFRecord.
  slakh_run = _train_cli(torch, [
      '--model', DATA_MODEL, '--data', slakh, '--dataset', 'slakh',
      '--batch_size', DATA_BATCH, '--remat', '--attention', 'flash',
      '--bf16', '--steps', 2, '--log_every', 1, '--device', DEVICE])
  assert f'dataset: {DATA_SLAKH_RECORDS} examples' in slakh_run['text']
  _check_launches(slakh_run, model)

  # Each kernel against its plain version at the shapes of these runs.
  path_checks = _path_checks(torch, config, cache, validation)

  # (d) The data layer's host cost.
  cost = _host_cost(torch, cache, config)
  tokens = DATA_BATCH * config.run.targets_length
  runs = {'recipe': first, 'resumed': resumed, 'slakh': slakh_run}
  for label, r in runs.items():
    r['target_tokens_per_s'] = tokens / r['ms_per_step'] * 1e3
    log(f'phase 11 (c/d) {label}: {r["steps"]} steps, {r["staged"]} batches '
        f'staged; {r["ms_per_step"]:.1f} ms a step (evaluation excluded) = '
        f'{r["target_tokens_per_s"]:.0f} target tokens/s; waited '
        f'{r["wait_ms"]:.1f} ms a step on prefetch; evaluation '
        f'{r["eval_s"]:.1f}s; losses '
        f'{[round(l, 4) for l in r["losses"]]}; {r["seconds"]:.1f}s in all; '
        f'launches {r["launches"]}')
  build_s = float(built.group(2))
  log(f'phase 11 (d) segment cache: {DATA_CLIPS} segments built in '
      f'{build_s:.2f}s = {build_s / DATA_CLIPS:.3f} s a segment (synth '
      f'render, tokenization, TFRecord write); {eval_batches} evaluation '
      'segment batches')
  launches = {}
  for r in runs.values():
    for name, n in r['launches'].items():
      launches[name] = launches.get(name, 0) + n
  log(f'phase 11 launches: {launches}')
  RESULTS['data'] = dict(
      reader=reader, path_checks=path_checks, cache_build_s=build_s,
      cache_build_s_per_segment=build_s / DATA_CLIPS,
      eval_batches=eval_batches, host_cost=cost, launches=launches,
      eval=record, runs={k: {key: v for key, v in r.items() if key != 'text'}
                         for k, r in runs.items()})
  return launches


# ---------------------------------------------------------------------------
# Phase 12: the ('data', 'model') mesh (mt3_tpu_torch/parallel/), one process
# per rank, beside the single-process path in this process
# ---------------------------------------------------------------------------
MESH_STEPS = 256          # greedy decode steps held against one process
MESH_ROWS = 8             # bench.py's first 8 segments (numpy seed 0)
MESH_TRAIN_BATCH = 8      # float32 steps held against one process
MESH_TRAIN_STEPS = 3
MESH_LOSS_RTOL = 2e-4
MESH_PARAM_ATOL = 2e-5    # a (1, 2) checkpoint against one process's state
MESH_TIMEOUT = 420        # seconds any phase 12 process may take
# job -> (mesh shape (data, model), backend, tasks of its main path)
MESH_JOBS = {
    'nccl_1x1': ((1, 1), 'nccl', ('train32', 'serve32')),
    'gloo_1x2': ((1, 2), 'gloo', ('decode', 'train32', 'checkpoint',
                                  'train16')),
    'gloo_2x1': ((2, 1), 'gloo', ('decode', 'train32', 'serve16')),
}
# Kernel C's launches in a train step at mt3 depth: 8 encoder and 8 decoder
# self-attention calls, 8 cross-attention calls.
MESH_FLASH_PER_STEP = {'fwd': 24, 'dkv': 24, 'dq': 24}
# Launch counters of the kernels line that phase 12's main paths reach.
MESH_KERNELS = ('logmel', 'decode_attention', 'decode_attention_int4_gqa',
                'flash_attention_fwd', 'flash_attention_dkv',
                'flash_attention_dq')


def _mesh_config(production=False, targets_length=None):
  """mt3 width and depth in float32, flash training attention, dropout 0,
  warmup 1; the production decode configuration on request; the served
  decode cut to targets_length steps."""
  from mt3_tpu_torch.core import config as config_lib
  config = config_lib.mt3_config()
  model = dataclasses.replace(config.model, dtype='float32',
                              train_attention_impl='flash', dropout_rate=0.0,
                              **(PRODUCTION if production else {}))
  run = dataclasses.replace(config.run, warmup_steps=1,
                            targets_length=(targets_length or
                                            config.run.targets_length))
  return dataclasses.replace(config, model=model, run=run)


def _mesh_launches():
  from mt3_tpu_torch.ops import decode_attention, flash_attention, logmel
  variants = decode_attention.VARIANT_LAUNCHES
  return {'logmel': logmel.LAUNCHES,
          'decode_attention': variants.get('mha', 0),
          'decode_attention_int4_gqa': variants.get('int4_gqa', 0),
          **{f'flash_attention_{k}': v
             for k, v in flash_attention.LAUNCHES.items()}}


def _mesh_decode(torch, config, mesh):
  """bench.py's first MESH_ROWS segments (a mesh rank: its rows): log-mel,
  encoder and MESH_STEPS greedy steps (PAD masked) with the kernels, params
  from torch seed 0.  Returns the tokens [steps, rows] and whether each
  step's top-2 gap exceeds TOP2_GAP, on the host (gathered over 'data'),
  and the seconds."""
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.ops import spectrogram
  from mt3_tpu_torch.parallel import partitioning

  model = config.model
  params = params_lib.init_params(model)
  frames = torch.from_numpy(np.random.RandomState(0).randn(
      MESH_ROWS, config.run.inputs_length,
      config.spectrogram.hop_width).astype(np.float32))
  if mesh is None:
    device, params = DEVICE, params_lib.to_device(params, DEVICE)
  else:
    device = mesh.device
    params = partitioning.shard_params(params, params_lib.param_axes(model),
                                       mesh, model)
    frames = partitioning.shard_batch({'frames': frames}, mesh)['frames']
  torch.cuda.synchronize()
  start = time.perf_counter()
  with torch.inference_mode():
    mel = spectrogram.compute_logmel(
        spectrogram.flatten_frames(frames.to(device)), config.spectrogram)
    encoded = t5.encode(params, model, mel, mesh=mesh)
    state = t5.init_decode_state(params, model, encoded, MESH_STEPS,
                                 mesh=mesh)
    token = torch.zeros(frames.shape[0], dtype=torch.int32, device=device)
    tokens, clear = [], []
    for _ in range(MESH_STEPS):
      logits, state = t5.decode_step(params, model, token, state, mesh=mesh)
      token, gap = _greedy(torch, logits)
      tokens.append(token)
      clear.append(gap)
    tokens = torch.stack(tokens).cpu()
    clear = torch.stack(clear).cpu().to(torch.int32)
  seconds = time.perf_counter() - start
  if mesh is not None:
    tokens, clear = (partitioning.all_gather(t, mesh, partitioning.DATA_AXIS,
                                             dim=1) for t in (tokens, clear))
  return tokens, clear.bool(), seconds


def _mesh_trainer(torch, mesh, dtype='float32', dropout=0.0,
                  batch_size=MESH_TRAIN_BATCH):
  from mt3_tpu_torch.train import trainer as trainer_lib
  config = _mesh_config()
  model = dataclasses.replace(config.model, dtype=dtype, dropout_rate=dropout)
  trainer = trainer_lib.Trainer(model, config.run, mesh=mesh, seed=0,
                                device=DEVICE)
  batch = trainer_lib.make_train_batch(
      np.random.RandomState(0), batch_size, config.run.inputs_length,
      config.run.targets_length, model.input_depth, model.vocab_size)
  return trainer, trainer.shard_batch(batch)


def _mesh_steps(torch, trainer, batch, steps):
  """Losses, seconds and kernel C's launches of each step."""
  from mt3_tpu_torch.ops import flash_attention
  out = []
  for _ in range(steps):
    before = dict(flash_attention.LAUNCHES)
    torch.cuda.synchronize()
    start = time.perf_counter()
    loss = float(trainer.step(batch)['loss'])
    seconds = time.perf_counter() - start
    out.append(dict(loss=loss, seconds=seconds, flash={
        k: v - before[k] for k, v in flash_attention.LAUNCHES.items()}))
  return out


def _mesh_request(torch, config, params, mesh):
  """One request (a 4 s chord clip) through Transcriber, with the params
  split over the mesh by their logical axes: each segment's tokens and the
  seconds."""
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.infer.transcribe import Transcriber
  kwargs = (dict(device=DEVICE) if mesh is None else dict(
      mesh=mesh, params_axes=params_lib.param_axes(config.model)))
  transcriber = Transcriber(config, params, **kwargs)
  start = time.perf_counter()
  predictions = transcriber.predict_segments(chord_clip(4.0, seed=12))
  return ([np.asarray(p['est_tokens']).tolist() for p in predictions],
          time.perf_counter() - start)


def _mesh_kernel_checks(torch):
  """B and C against their plain versions at a (1, 2) rank's shapes:
  B's multi-head kernel at h=3 (float32 caches of MESH_STEPS positions)
  and its grouped kernel at 3 query heads over 1 K/V head with an int4
  cache (the production configuration), b=MESH_ROWS, at the split
  boundaries; C at h=3 in float32 at b=MESH_TRAIN_BATCH and in bf16 at
  b=TRAIN_BATCH on the three attention shapes, q/k/v as transposed views
  (as layers.attention passes them).  Launches here are not counted."""
  from mt3_tpu_torch.ops import decode_attention
  from mt3_tpu_torch.ops import flash_attention as fa
  gen = torch.Generator(device=DEVICE).manual_seed(12)
  out = {'decode_attention': {}, 'flash': {'float32': {}, 'bfloat16': {}}}
  split = decode_attention.L_SPLIT
  for name, kv, bits in (('mha', 3, None), ('int4_gqa', 1, 4)):
    errors = []
    for index in sorted({0, split - 1, split, MESH_STEPS - 1}):
      args = _variant_make(torch, gen, MESH_ROWS, 3, kv, 64, MESH_STEPS,
                           torch.float32, bits)
      idx = torch.tensor(index, dtype=torch.int32, device=DEVICE)
      before = _clone(args[3:])
      written = _clone(args[3:])
      got = decode_attention.decode_attention_inplace(
          *args[:3], written[0], written[1], idx, written[2], written[3])
      want, plain = _variant_plain(torch, args, idx)
      torch.cuda.synchronize()
      errors.append(_check_variant(
          torch, got, want, written, plain, before, index, torch.float32,
          ('phase 12', name, index)))
    out['decode_attention'][name] = max(errors)
  for b, dtype in ((MESH_TRAIN_BATCH, torch.float32),
                   (TRAIN_BATCH, torch.bfloat16)):
    for lq, lk, causal in FLASH_SHAPES:
      _flash_check(torch, fa, gen, out['flash'], lq, lk, causal,
                   strided=True, batch=b, dtypes=(dtype,), heads=3)
  return out


def _gloo_probe(torch, mesh):
  """Which collectives this torch's gloo runs on CUDA tensors, on a group
  of its own: each either runs or raises at once on every rank."""
  import torch.distributed as dist
  group = dist.new_group(backend='gloo')
  world = dist.get_world_size()
  x = torch.ones(world * 4, device=mesh.device)

  def gather_list():
    dist.all_gather([torch.empty_like(x) for _ in range(world)], x,
                    group=group)

  probes = {
      'all_reduce': lambda: dist.all_reduce(x.clone(), group=group),
      'broadcast': lambda: dist.broadcast(x.clone(), 0, group=group),
      'all_gather': gather_list,
      'all_gather_into_tensor': lambda: dist.all_gather_into_tensor(
          x.new_empty(world * x.numel()), x, group=group),
      'reduce_scatter_tensor': lambda: dist.reduce_scatter_tensor(
          x.new_empty(x.numel() // world), x, group=group),
      'all_to_all_single': lambda: dist.all_to_all_single(
          torch.empty_like(x), x, group=group),
  }
  out = {}
  for name, fn in probes.items():
    try:
      fn()
      torch.cuda.synchronize()
      out[name] = 'runs'
    except (RuntimeError, ValueError, NotImplementedError) as e:
      out[name] = f'raises: {str(e).splitlines()[0][:160]}'
  return out


def mesh_worker(torch, spec):
  """One rank of a phase 12 job: its main path between a reset and a
  reading of the launch counters, then (rank 0 of the (1, 2) job) the
  kernel checks and the gloo probe.  Returns its record."""
  import datetime

  import torch.distributed as dist

  from mt3_tpu_torch import load_transcriber
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.parallel import multihost, partitioning

  torch.backends.cudnn.allow_tf32 = False
  assert torch.get_float32_matmul_precision() == 'highest'
  (data, model_size), rank = spec['shape'], spec['rank']
  init = dict(backend=spec['backend'],
              timeout=datetime.timedelta(seconds=MESH_TIMEOUT - 60))
  if data * model_size > 1:
    multihost.initialize(f'file://{spec["store"]}', data * model_size, rank,
                         **init)
  else:   # multihost.initialize is a no-op for one process
    dist.init_process_group(init_method=f'file://{spec["store"]}',
                            world_size=1, rank=0, **init)
  mesh = partitioning.make_mesh(model_size, device=DEVICE)
  torch.cuda.reset_peak_memory_stats()
  out = {'rank': rank, 'coords': [mesh.data_index, mesh.model_index],
         'device': str(mesh.device), 'tasks': {}}
  tasks = out['tasks']
  start = time.perf_counter()
  _reset_launches()
  trainer = None
  for task in spec['tasks']:
    if task == 'decode':
      for label, production in (('mha', False), ('production', True)):
        tokens, clear, seconds = _mesh_decode(
            torch, _mesh_config(production), mesh)
        tasks[f'decode_{label}'] = dict(tokens=tokens.tolist(),
                                        clear=clear.tolist(), seconds=seconds)
    elif task == 'train32':
      trainer, batch = _mesh_trainer(torch, mesh)
      steps = (MESH_TRAIN_STEPS if spec['backend'] == 'gloo'
               else MESH_TRAIN_STEPS - 1)
      tasks['train32'] = _mesh_steps(torch, trainer, batch, steps)
    elif task == 'checkpoint':
      tasks['checkpoint'] = trainer.save(spec['checkpoint_dir'])
    elif task == 'train16':
      del trainer
      trainer16, batch = _mesh_trainer(torch, mesh, 'bfloat16', 0.1,
                                       TRAIN_BATCH)
      tasks['train16'] = _mesh_steps(torch, trainer16, batch, 2)
      del trainer16, batch
    elif task == 'serve32':
      config = _mesh_config(targets_length=MESH_STEPS)
      tokens, seconds = _mesh_request(
          torch, config, params_lib.init_params(config.model), mesh)
      tasks['serve32'] = dict(tokens=tokens, seconds=seconds)
    elif task == 'serve16':
      transcriber = load_transcriber(
          'mt3', device=mesh.device, mesh=mesh,
          params_axes=params_lib.param_axes(_mesh_config().model))
      begin = time.perf_counter()
      notes = transcriber(chord_clip(2.0, seed=13)).sorted_notes()
      tasks['serve16'] = dict(
          notes=[(n.pitch, n.start_time, n.end_time) for n in notes],
          seconds=time.perf_counter() - begin)
  torch.cuda.synchronize()
  out['seconds'] = time.perf_counter() - start
  out['launches'] = _mesh_launches()
  out['peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
  if spec.get('checks') and rank == 0:
    out['checks'] = _mesh_kernel_checks(torch)
  if spec.get('checks'):
    out['gloo_cuda'] = _gloo_probe(torch, mesh)
  dist.destroy_process_group()
  return out


def _mesh_spawn(store_dir):
  """Start every job's ranks at once; each rank's stderr goes to
  chiprun_out/mesh_<job>_<rank>.log."""
  procs = {}
  for job, (shape, backend, tasks) in MESH_JOBS.items():
    store = store_dir / f'{job}.store'
    store.unlink(missing_ok=True)
    for rank in range(shape[0] * shape[1]):
      spec = dict(shape=shape, backend=backend, tasks=tasks, rank=rank,
                  store=str(store), checks=job == 'gloo_1x2',
                  checkpoint_dir=str(store_dir / f'{job}_checkpoints'))
      err = open(OUT_DIR / f'mesh_{job}_{rank}.log', 'w')
      env = dict(os.environ, LOCAL_RANK=str(rank))
      procs[(job, rank)] = (subprocess.Popen(
          [sys.executable, str(pathlib.Path(__file__).resolve()),
           '--mesh_worker', json.dumps(spec)],
          stdout=subprocess.PIPE, stderr=err, text=True, env=env), err)
  return procs


def _mesh_cli(store_dir):
  """The train CLI as the README runs two ranks on one card: torchrun,
  --backend gloo, --num_model_partitions 2, mt3 in bf16 with flash
  attention, 2 steps at b=8 on synthetic data, a final checkpoint."""
  ckpt = store_dir / 'cli_checkpoints'
  err = open(OUT_DIR / 'mesh_cli.log', 'w')
  proc = subprocess.Popen(
      [sys.executable, '-m', 'torch.distributed.run', '--standalone',
       '--nproc_per_node', '2', '-m', 'mt3_tpu_torch.cli.train', '--model',
       'mt3', '--data', 'synthetic', '--num_model_partitions', '2',
       '--backend', 'gloo', '--attention', 'flash', '--bf16', '--steps', '2',
       '--batch_size', '8', '--log_every', '1', '--checkpoint_dir',
       str(ckpt)], cwd=ROOT, stdout=err, stderr=subprocess.STDOUT, text=True)
  return proc, err, ckpt


def _mesh_collect(procs):
  records = {}
  try:
    for (job, rank), (proc, err) in procs.items():
      out, _ = proc.communicate(timeout=MESH_TIMEOUT)
      err.close()
      assert proc.returncode == 0, (
          f'phase 12 {job} rank {rank} exited {proc.returncode}; see '
          f'chiprun_out/mesh_{job}_{rank}.log')
      records.setdefault(job, []).append(
          json.loads(out.strip().splitlines()[-1]))
  finally:
    for proc, err in procs.values():
      if proc.poll() is None:
        proc.kill()
        proc.communicate()
      err.close()
  return records


def _same_tokens(ref_tokens, ref_clear, got, label):
  """Greedy tokens [steps, rows] against one process's: each row equal up
  to its end, or up to a step where one process's top-2 gap was under
  TOP2_GAP (phase 5's near-tie allowance).  Returns (rows equal, rows cut
  at a near tie)."""
  got = np.asarray(got)
  ref_tokens, ref_clear = np.asarray(ref_tokens), np.asarray(ref_clear)
  assert got.shape == ref_tokens.shape, (label, got.shape)
  equal = cut = 0
  for row in range(got.shape[1]):
    differ = np.nonzero(got[:, row] != ref_tokens[:, row])[0]
    if not differ.size:
      equal += 1
      continue
    step = int(differ[0])
    assert not ref_clear[step, row], (label, 'row', row, 'step', step)
    cut += 1
  return equal, cut


def phase_mesh(torch):
  """Phase 12: the mesh.  Starts every job's ranks, computes the
  single-process references on the card meanwhile, then holds each rank
  to them; returns the ranks' launches summed per kernel."""
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.train import trainer as trainer_lib

  t0 = time.perf_counter()
  store_dir = WORK_DIR / 'mesh'
  shutil.rmtree(store_dir, ignore_errors=True)
  store_dir.mkdir(parents=True)
  OUT_DIR.mkdir(exist_ok=True)
  procs = _mesh_spawn(store_dir)
  cli, cli_log, cli_ckpt = _mesh_cli(store_dir)

  ref = {}
  for label, production in (('mha', False), ('production', True)):
    ref[f'decode_{label}'] = _mesh_decode(torch, _mesh_config(production),
                                          None)
  ref_trainer, batch = _mesh_trainer(torch, None)
  ref['train32'] = _mesh_steps(torch, ref_trainer, batch, MESH_TRAIN_STEPS)
  config = _mesh_config(targets_length=MESH_STEPS)
  ref['serve32'] = _mesh_request(torch, config,
                                 params_lib.init_params(config.model), None)
  ref_s = time.perf_counter() - t0

  records = _mesh_collect(procs)
  try:
    cli.wait(timeout=MESH_TIMEOUT)
  finally:
    if cli.poll() is None:
      cli.kill()
      cli.wait()
    cli_log.close()
  seconds = time.perf_counter() - t0
  cli_text = (OUT_DIR / 'mesh_cli.log').read_text()
  assert cli.returncode == 0, cli_text[-4000:]
  assert 'mesh: data 1, model 2' in cli_text and 'step 1: loss=' in cli_text
  from mt3_tpu_torch.core import config as config_lib
  cli_config = config_lib.mt3_config()
  cli_trainer = trainer_lib.Trainer(cli_config.model, cli_config.run,
                                    device=DEVICE)
  assert cli_trainer.restore(str(cli_ckpt)) == 2
  assert all(torch.isfinite(p).all() for p in params_lib.tree_leaves(
      cli_trainer.state.params))
  del cli_trainer
  ref_losses = [s['loss'] for s in ref['train32']]
  launches = dict.fromkeys(MESH_KERNELS, 0)
  summary = {}
  for job, ranks in records.items():
    shape = MESH_JOBS[job][0]
    for r in ranks:
      tasks = r['tasks']
      for name, n in r['launches'].items():
        if name in launches:
          launches[name] += n
      for label in ('mha', 'production'):
        if f'decode_{label}' in tasks:
          tokens, clear, _ = ref[f'decode_{label}']
          equal, cut = _same_tokens(tokens, clear,
                                    tasks[f'decode_{label}']['tokens'],
                                    (job, r['rank'], label))
          summary[f'{job} decode {label}'] = dict(
              rows_equal=equal, rows_cut_at_near_tie=cut,
              seconds=tasks[f'decode_{label}']['seconds'])
      if 'train32' in tasks:
        losses = [s['loss'] for s in tasks['train32']]
        np.testing.assert_allclose(losses, ref_losses[:len(losses)],
                                   rtol=MESH_LOSS_RTOL, err_msg=job)
        summary[f'{job} train32 losses'] = losses
      if 'train16' in tasks:
        for step in tasks['train16']:
          assert math.isfinite(step['loss']), (job, step)
          assert step['flash'] == MESH_FLASH_PER_STEP, step
        summary[f'{job} train16'] = tasks['train16']
      if 'serve32' in tasks:
        assert tasks['serve32']['tokens'] == ref['serve32'][0], job
      if 'serve16' in tasks:
        assert tasks['serve16']['notes'] == ranks[0]['tasks']['serve16'][
            'notes'], (job, 'ranks disagree')
    assert len(ranks) == shape[0] * shape[1], job

  path = records['gloo_1x2'][0]['tasks']['checkpoint']
  restored = trainer_lib.Trainer(ref_trainer.model_config,
                                 ref_trainer.run_config, seed=7,
                                 device=DEVICE)
  assert restored.restore(path) == MESH_TRAIN_STEPS
  worst = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(
      params_lib.tree_leaves(restored.state.params),
      params_lib.tree_leaves(ref_trainer.state.params)))
  assert worst <= MESH_PARAM_ATOL, worst

  checks = records['gloo_1x2'][0]['checks']   # asserted in the rank
  for job, ranks in records.items():
    for r in ranks:
      log(f'phase 12 {job} rank {r["rank"]} {tuple(r["coords"])} on '
          f'{r["device"]}: main path {r["seconds"]:.1f}s, peak '
          f'{r["peak_gib"]:.2f} GiB, launches {r["launches"]}')
  for key, value in summary.items():
    log(f'phase 12 {key}: {value}')
  log(f'phase 12 checkpoint from (1, 2) restored in one process: worst '
      f'parameter difference {worst:.3e} (atol {MESH_PARAM_ATOL})')
  log(f'phase 12 per-rank kernels: B {checks["decode_attention"]} max_abs_err '
      f'(h=3 multi-head; 3 over 1 K/V head, int4); C at h=3 '
      + json.dumps({dt: {k: {n: round(v.get('tile_rel', v['max_abs']), 6)
                             for n, v in e.items()} for k, e in d.items()}
                    for dt, d in checks['flash'].items()}))
  log(f'phase 12 gloo on CUDA tensors: {records["gloo_1x2"][0]["gloo_cuda"]}')
  log('phase 12 train CLI under torchrun, 2 gloo ranks on one card: '
      + ' | '.join(line for line in cli_text.splitlines()
                   if line.startswith(('mesh:', 'step ', 'saved')))
      + '; its checkpoint restored in one process')
  log('phase 12 one process on the card (the references): decodes '
      f'{ref["decode_mha"][2]:.1f}s (mha) and '
      f'{ref["decode_production"][2]:.1f}s (production) for {MESH_STEPS} '
      'steps, float32 steps '
      + ', '.join(f'{s["seconds"]:.2f}s' for s in ref['train32'])
      + f', the request {ref["serve32"][1]:.1f}s')
  log(f'phase 12: {seconds:.1f}s (references in this process '
      f'{ref_s:.1f}s; every rank shares the one card and its host with the '
      'others: the times are of time-sharing, not of a multi-GPU run); '
      f'launches summed over ranks {launches}')
  for name in MESH_KERNELS:
    assert launches[name] > 0, (name, launches)
  RESULTS['mesh'] = dict(seconds=seconds, reference_seconds=ref_s,
                         summary=summary, checkpoint_worst=worst,
                         ranks=records, launches=launches)
  return launches


PHASES = ('kernels', 'serve', 'modes', 'forced', 'profile', 'production',
          'flash', 'train', 'evaluate', 'data', 'mesh')


def main(argv=None):
  import argparse
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--phases', default=','.join(PHASES),
                      help='comma-separated subset of ' + ', '.join(PHASES)
                           + ' (environment and build always run); the '
                           'result lines are printed only for all of them')
  parser.add_argument('--mesh_worker', default=None,
                      help='(internal) run one rank of phase 12 from its '
                           'JSON spec and print its record')
  args = parser.parse_args(argv)
  phases = args.phases.split(',')
  unknown = set(phases) - set(PHASES)
  if unknown:
    parser.error(f'unknown phases {sorted(unknown)}')
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  import mt3_tpu_torch  # noqa: F401  (fails when the package is absent)
  if args.mesh_worker:
    print(json.dumps(mesh_worker(torch, json.loads(args.mesh_worker))))
    return 0

  t0 = time.perf_counter()
  card = phase_environment(torch)
  phase_build()
  kernels, launches = {}, {}
  if 'kernels' in phases:
    kernels.update(phase_kernels(torch))
  if 'serve' in phases:
    launches.update(phase_serve(torch))
  if 'modes' in phases:
    launches.update(phase_decode_modes(torch))
  if 'forced' in phases:
    phase_forced_tokens(torch)
  if 'profile' in phases:
    phase_profile(torch)
  if 'production' in phases:
    launches.update(phase_production(torch))
  if 'flash' in phases:
    kernels.update(phase_flash(torch))
  if 'train' in phases:
    phase_train_parity(torch)
    # Kernel C's launches come from the training path (phase 8b: 6 steps,
    # the last on a pipeline batch through kernel A).
    launches.update({k: v for k, v in phase_train(torch).items()
                     if k.startswith('flash')})
    phase_train_cli()
  if 'evaluate' in phases:
    phase_evaluate(torch)
  if 'data' in phases:
    for name, count in phase_data(torch).items():
      launches[name] = launches.get(name, 0) + count
  if 'mesh' in phases:
    for name, count in phase_mesh(torch).items():
      launches[name] = launches.get(name, 0) + count
  RESULTS['seconds'] = time.perf_counter() - t0
  OUT_DIR.mkdir(exist_ok=True)
  RESULTS['kernels'] = [dict(entry, launches=launches.get(name))
                        for name, entry in kernels.items()]
  (OUT_DIR / 'chip_smoke.json').write_text(json.dumps(RESULTS, indent=1))
  log(f'total {RESULTS["seconds"]:.1f}s')
  if set(phases) != set(PHASES):
    log(f'ran phases {phases} only: no result lines')
    return 0

  # Launches: A and B (multi-head) on the served path (phase 4), B's
  # grouped variants on the decode-mode requests and the production batch
  # (phase 9), C on the training path (phase 8b); A, B (multi-head) and C
  # on the flagship recipe (phase 11) and A, B (multi-head and int4_gqa)
  # and C on the mesh's ranks (phase 12) added to them.
  order = ('logmel', 'decode_attention',
           *(f'decode_attention_{v}' for v in B_VARIANTS),
           'flash_attention_fwd', 'flash_attention_dkv', 'flash_attention_dq')
  line = {'kernels': [dict(kernels[name], launches=launches[name])
                      for name in order]}
  for entry in line['kernels']:
    assert entry['launches'] > 0, entry
  print(json.dumps(line))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
