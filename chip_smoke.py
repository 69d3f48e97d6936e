"""Run the PyTorch port (mt3_tpu_torch) on one NVIDIA GPU and check it.

Usage, from the root of the repository, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from mt3_tpu_torch/csrc/ (nvcc, at
first use), then runs six phases; each raises on failure:

  1. environment: torch / CUDA versions, the card's name and power limit;
     TF32 off for matmul and cuDNN.
  2. build: both kernels compiled concurrently, timed, with ptxas' report.
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the served path gives it, timed beside its bound and, where one
     exists, a one-call PyTorch yardstick (never used by the port).
  4. the served path at mt3 width: load_transcriber('mt3') (bfloat16,
     random weights from torch seed 0) answers 3 requests; both kernels'
     launch counts are checked against the segment batches and decode steps
     that ran; the CLI transcribes a written wav to MIDI.
  5. kernel path against plain path through the whole model in float32:
     one segment batch, 256 decode steps on the card with the kernels,
     the same tokens through the plain path on the CPU.
  6. where the time goes: one served segment batch (64 decode steps) under
     torch.profiler: wall time, device busy time, top kernels.

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
import pathlib
import subprocess
import sys
import time
import wave

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / 'chiprun_out'
WORK_DIR = ROOT / 'build' / 'chip_smoke'

# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM bandwidth.  Bounds below use them.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

LOGMEL_ATOL = 5e-3        # as tests/test_pallas_logmel.py holds the TPU kernel
ATTN_ATOL_F32 = 1e-5      # as tests/test_pallas_decode_attention.py
ATTN_TOL_BF16 = 1e-2      # x (1 + |out|): bf16 output rounding is 2**-9 relative
FORCED_LOGITS_ATOL = 1e-3
TOP2_GAP = 1e-3

RESULTS = {}
DEVICE = 'cuda'


def log(msg):
  print(msg, flush=True)


def bound(flops, nbytes):
  ops_ms = flops / PEAK_FP32_FLOPS * 1e3
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
  from mt3_tpu_torch.ops import cuda_build
  start = time.perf_counter()
  paths = cuda_build.build(['logmel', 'decode_attention'])
  seconds = time.perf_counter() - start
  for name, (secs, report) in cuda_build.BUILD_LOGS.items():
    lines = [l for l in report.splitlines() if 'registers' in l or 'spill' in l]
    log(f'built {name} in {secs:.1f}s: ' + ' | '.join(l.strip() for l in lines))
  log(f'phase 2 build: {seconds:.1f}s -> {sorted(str(p) for p in paths.values())}')
  RESULTS['build_s'] = seconds
  for name in paths:
    cuda_build.library(name)


def phase_kernels(torch):
  import torch.nn.functional as F
  from mt3_tpu_torch.core.config import SpectrogramConfig
  from mt3_tpu_torch.ops import decode_attention, logmel, spectrogram

  dev = torch.device(DEVICE)
  kernels = {}

  # Kernel A at the served shape: 8 segments x 256 frames x 128 samples.
  cfg = SpectrogramConfig()
  b, n = 8, 256 * cfg.hop_width
  audio = np.stack([chord_clip(n / cfg.sample_rate, seed=s) for s in range(b)])
  x = torch.from_numpy(audio).to(dev)
  got = logmel.logmel_fused(x, cfg)
  want = logmel.logmel_plain(x, cfg)
  torch.cuda.synchronize()
  assert got.shape == want.shape == (b, n // cfg.hop_width, cfg.num_mel_bins)
  assert torch.isfinite(got).all()
  err = float((got - want).abs().max())
  log(f'kernel A logmel: max_abs_err {err:.3e} (atol {LOGMEL_ATOL})')
  assert err <= LOGMEL_ATOL, err
  # Bound of the function: what an FFT-based log-mel needs.  Per frame:
  # the window, a real FFT of fft_size points (2.5 N log2 N flops), the
  # magnitude (4 a bin), the mel product over the filters' nonzeros and
  # the clamp + log; bytes: the audio once, the output once, the window
  # and the nonzero mel weights with their indices.
  frames = b * n // cfg.hop_width
  n_freq = cfg.fft_size // 2 + 1
  mel_nnz = int(np.count_nonzero(spectrogram._mel_matrix(cfg)))
  fft_flops = 2.5 * cfg.fft_size * math.log2(cfg.fft_size)
  flops = frames * (cfg.fft_size + fft_flops + 4 * n_freq + 2 * mel_nnz
                    + 2 * cfg.num_mel_bins)
  nbytes = 4 * (b * n + frames * cfg.num_mel_bins + cfg.fft_size
                + 2 * mel_nnz)
  bound_ms, bound_by = bound(flops, nbytes)
  # Second figure: the bound of the algorithm this kernel (like the TPU
  # kernel) runs, a dense windowed DFT and a dense mel product as matmuls,
  # at the float32 rate outside the tensor cores.
  dense_flops = (2 * frames * cfg.fft_size * n_freq * 2
                 + 2 * frames * n_freq * cfg.num_mel_bins)
  dense_bytes = 4 * (b * n + 2 * cfg.fft_size * n_freq
                     + n_freq * cfg.num_mel_bins + frames * cfg.num_mel_bins)
  dense_ms, dense_by = bound(dense_flops, dense_bytes)
  ms = time_ms(torch, lambda: logmel.logmel_fused(x, cfg), 20)
  plain_ms = time_ms(torch, lambda: logmel.logmel_plain(x, cfg), 20)
  log(f'kernel A logmel [{b}, {n}]: kernel_ms {ms:.4f}  plain_ms '
      f'{plain_ms:.4f}  library_ms null  bound_ms {bound_ms:.6f} ({bound_by}, '
      f'{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.2f} MB)  matmul-DFT '
      f'algorithm bound_ms {dense_ms:.4f} ({dense_by}, '
      f'{dense_flops / 1e9:.2f} GFLOP)')
  RESULTS['logmel_bounds'] = dict(
      function=dict(ms=bound_ms, by=bound_by, flops=flops, bytes=nbytes,
                    mel_nonzeros=mel_nnz),
      matmul_dft_algorithm=dict(ms=dense_ms, by=dense_by, flops=dense_flops,
                                bytes=dense_bytes))
  kernels['logmel'] = dict(
      name='logmel', route='cuda', source='mt3_tpu_torch/csrc/logmel.cu',
      replaces='mt3_tpu/ops/pallas/logmel.py:81', max_abs_err=err, ms=ms,
      plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
      library_ms=None)

  # Kernel B at the served shapes: b=8, h=6, d=64 (mt3), caches of
  # 128..1024; and at tiny_config's h=4, d=8, its other instantiation.
  b = 8
  errors = {torch.float32: 0.0, torch.bfloat16: 0.0}
  gen = torch.Generator(device=dev).manual_seed(0)
  for (h, d), dtype, length in itertools.product(
      ((6, 64), (4, 8)), (torch.float32, torch.bfloat16), (128, 512, 1024)):
    for index in sorted({0, 1, 127, 128, 255, 256, 300, 511, 512,
                         length - 1} & set(range(length))):
      q = torch.randn(b, h, d, device=dev, generator=gen) / 8
      nk, nv = (torch.randn(b, h, d, device=dev, generator=gen)
                for _ in range(2))
      ck, cv = (torch.randn(b, h, d, length, device=dev, generator=gen)
                for _ in range(2))
      q, nk, nv, ck, cv = (t.to(dtype) for t in (q, nk, nv, ck, cv))
      idx = torch.tensor(index, dtype=torch.int32, device=dev)
      k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
      got = decode_attention.decode_attention_inplace(q, nk, nv, k1, v1, idx)
      decode_attention.decode_attention_plain(q, nk, nv, k2, v2, idx)
      # The kernel computes in float32 and rounds only its output, so it
      # is held against the plain version in float32 on the same values.
      want = decode_attention.decode_attention_plain(
          *(t.float() for t in (q, nk, nv, ck, cv)), idx)
      torch.cuda.synchronize()
      assert got.dtype == dtype and torch.isfinite(got.float()).all()
      assert torch.equal(k1, k2) and torch.equal(v1, v2), (dtype, length,
                                                            index)
      assert torch.equal(k1[..., index + 1:], ck[..., index + 1:])
      diff = (got.float() - want).abs()
      errors[dtype] = max(errors[dtype], float(diff.max()))
      if dtype == torch.float32:
        assert float(diff.max()) <= ATTN_ATOL_F32, (d, length, index,
                                                    diff.max())
      else:
        excess = diff - ATTN_TOL_BF16 * (1 + want.abs())
        assert float(excess.max()) <= 0, (d, length, index, diff.max())
  log(f'kernel B decode_attention: max_abs_err f32 {errors[torch.float32]:.3e} '
      f'(atol {ATTN_ATOL_F32}), bf16 {errors[torch.bfloat16]:.3e} (tolerance '
      f'{ATTN_TOL_BF16} x (1 + |out|)); caches equal to the plain write; '
      f'head dims 64 and 8')

  # Timed at the served shape and dtype and the longest prefix a segment
  # reaches.  As in a served step, each call takes the next of 8 layers'
  # caches (8 x 12.6 MB, twice the 50 MB L2), so the prefix comes from HBM
  # as the bytes bound assumes.
  h, d, length, index, dtype = 6, 64, 1024, 1023, torch.bfloat16
  layers = []
  for _ in range(8):
    q = (torch.randn(b, h, d, device=dev, generator=gen) / 8).to(dtype)
    nk, nv = (torch.randn(b, h, d, device=dev, generator=gen).to(dtype)
              for _ in range(2))
    ck, cv = (torch.randn(b, h, d, length, device=dev,
                          generator=gen).to(dtype) for _ in range(2))
    layers.append((q, nk, nv, ck, cv))
  idx = torch.tensor(index, dtype=torch.int32, device=dev)

  def rotating(fn, args):
    cycle = itertools.cycle(args)
    return lambda: fn(*next(cycle))

  ms = time_ms(torch, rotating(
      lambda *a: decode_attention.decode_attention_inplace(*a, idx), layers),
      200)
  plain_ms = time_ms(torch, rotating(
      lambda *a: decode_attention.decode_attention_plain(*a, idx), layers),
      200)
  # Yardstick only: attention over the pre-transposed live prefix, over
  # the same 8 layers' worth of caches.
  yard = [(q[:, :, None, :],
           ck[..., :index + 1].transpose(-1, -2).contiguous(),
           cv[..., :index + 1].transpose(-1, -2).contiguous())
          for q, _, _, ck, cv in layers]
  library_ms = time_ms(torch, rotating(
      lambda q, kt, vt: F.scaled_dot_product_attention(q, kt, vt, scale=1.0),
      yard), 200)
  elt = 2
  nbytes = (2 * b * h * d * index * elt     # K and V prefix read
            + 3 * b * h * d * elt           # q, new k, new v
            + b * h * d * elt               # out
            + 2 * b * h * d * elt)          # the written column
  flops = 4 * b * h * d * (index + 1)
  bound_ms, bound_by = bound(flops, nbytes)
  log(f'kernel B decode_attention [b={b}, h={h}, d={d}, len={length}, '
      f'index={index}, bf16]: kernel_ms {ms:.5f}  plain_ms {plain_ms:.5f}  '
      f'library_ms {library_ms:.5f}  bound_ms {bound_ms:.6f} ({bound_by}, '
      f'{nbytes / 1e6:.2f} MB)')
  kernels['decode_attention'] = dict(
      name='decode_attention', route='cuda',
      source='mt3_tpu_torch/csrc/decode_attention.cu',
      replaces='mt3_tpu/ops/pallas/decode_attention_v3.py:159',
      max_abs_err=errors[torch.float32], ms=ms, plain_ms=plain_ms,
      bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
  RESULTS['decode_attention_bf16_max_abs_err'] = errors[torch.bfloat16]
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
  decode_attention.LAUNCHES = 0
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
  pcm = np.clip(clips[0] * 32767, -32768, 32767).astype(np.int16)
  with wave.open(str(wav_path), 'wb') as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(sr)
    w.writeframes(pcm.tobytes())
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
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.codec.vocabulary import PAD_ID
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.infer import transcribe
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.ops import spectrogram

  config = config_lib.mt3_config()
  model = dataclasses.replace(config.model, dtype='float32')
  params = params_lib.init_params(model)   # torch seed 0, on the CPU
  batch = transcribe.audio_to_segments(chord_clip(10.0, seed=11), config)[0]
  steps = 256

  def run(device, forced=None):
    p = params_lib.to_device(params, device)
    frames = torch.from_numpy(batch.frames).to(device)
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
        if forced is None:
          masked = logits.clone()
          masked[:, PAD_ID] = -1e10
          token = torch.argmax(masked, dim=-1).to(torch.int32)
        else:
          token = forced[step].to(device)
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
  masked = logits_p.clone()
  masked[..., PAD_ID] = -1e10
  top2 = masked.topk(2, dim=-1).values
  clear = (top2[..., 0] - top2[..., 1]) > TOP2_GAP
  agree = masked.argmax(-1).to(torch.int32) == tokens_k
  log(f'phase 5 forced tokens (float32, b={tokens_k.shape[1]}, {steps} '
      f'steps): logmel err {mel_err:.3e}, encoder err {enc_err:.3e}, logits '
      f'max_abs_err {logit_err:.3e} (atol {FORCED_LOGITS_ATOL}); greedy '
      f'agrees at {int((agree & clear).sum())}/{int(clear.sum())} clear '
      f'steps; card {gpu_s:.1f}s, cpu {cpu_s:.1f}s')
  assert logit_err <= FORCED_LOGITS_ATOL, logit_err
  assert bool(agree[clear].all())
  RESULTS['forced_tokens'] = dict(
      logmel_err=mel_err, encoder_err=enc_err, logits_err=logit_err,
      clear_steps=int(clear.sum()), agree_steps=int((agree & clear).sum()))


def phase_profile(torch):
  """Where the time goes: one segment batch, 64 decode steps, profiled."""
  from torch.profiler import ProfilerActivity, profile
  import mt3_tpu_torch
  from mt3_tpu_torch.infer import transcribe

  transcriber = mt3_tpu_torch.load_transcriber('mt3', device=DEVICE)
  config = transcriber.config
  batch = transcribe.audio_to_segments(chord_clip(4.0, seed=10), config)[0]
  frames = torch.from_numpy(batch.frames).to(DEVICE)

  def run():
    with torch.inference_mode():
      tokens, _ = transcribe._transcribe_batch(
          transcriber.params, config.model, config.spectrogram, frames, 64,
          0.0, None)
    torch.cuda.synchronize()
    return tokens

  run()  # warm up
  start = time.perf_counter()
  run()
  wall_ms = (time.perf_counter() - start) * 1e3
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    run()
  # Kernels only: CPU-side ops carry their kernels' time too.
  rows = [(e.key, e.self_device_time_total / 1e3, e.count)
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0]
  busy_ms = sum(r[1] for r in rows)
  rows.sort(key=lambda r: -r[1])
  share = None if not rows else 1.0 - busy_ms / wall_ms
  log(f'phase 6 profile (1 batch, log-mel + encoder + 64 decode steps): '
      f'wall {wall_ms:.1f} ms unprofiled, device busy {busy_ms:.1f} ms '
      f'(kernel time under the profiler), idle share '
      f'{"not measured" if share is None else f"{share:.3f}"}')
  for key, ms, count in rows[:8]:
    log(f'  {ms:9.3f} ms  {count:6d}x  {key[:90]}')
  RESULTS['profile'] = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                            idle_share=share,
                            top=[list(r) for r in rows[:8]])


def main():
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  import mt3_tpu_torch  # noqa: F401  (fails when the package is absent)

  t0 = time.perf_counter()
  card = phase_environment(torch)
  phase_build()
  kernels = phase_kernels(torch)
  launches = phase_serve(torch)
  phase_forced_tokens(torch)
  phase_profile(torch)
  RESULTS['seconds'] = time.perf_counter() - t0

  line = {'kernels': [dict(kernels[name], launches=launches[name])
                      for name in ('logmel', 'decode_attention')]}
  RESULTS['kernels'] = line['kernels']
  OUT_DIR.mkdir(exist_ok=True)
  (OUT_DIR / 'chip_smoke.json').write_text(json.dumps(RESULTS, indent=1))
  log(f'total {RESULTS["seconds"]:.1f}s')
  print(json.dumps(line))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
