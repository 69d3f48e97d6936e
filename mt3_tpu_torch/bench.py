"""Benchmark: audio-seconds transcribed per second per device (port of
bench.py, with its constants, flags and JSON keys).

Measures bench.py's workload on the port: 1024 segments of 256 frames
(2.048 s of audio each) through log-mel (kernel A), the encoder and the
full KV-cached autoregressive decode (kernel B), 16 decode steps between
two all-done checks, on the flagship mt3 model in the JAX package's
production decode configuration (bench.py:95-114: bf16 activations, int4
self-attention cache, int8 cross-attention K/V, the stacked carry and one
K/V head; `--kv_heads 0` is plain multi-head attention).

Default (no args): random weights (torch seed 0) with `forbid_eos`, the
worst case, since greedy decode runs the full 1024-token budget.  With
`--checkpoint DIR` trained weights are loaded (the port's checkpoint_<step>.pt
files or the JAX package's orbax directories, through
train/checkpoint.load_params), held-out corpus audio is transcribed, and
the EOS early exit is live.

One warm-up pass, then three timed passes; each pass fetches its tokens to
the host inside the timing, as bench.py does.  Prints the card's name and
power limit, the three timed passes' seconds, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
plus "mode" and "mean_decode_len" with --checkpoint.  The value is the
rate of this process's device divided by the number of visible CUDA
devices, the formula of bench.py:175 (which divides by
jax.local_device_count()); vs_baseline is against 50x real time per
device.

Usage:
  python -m mt3_tpu_torch.bench [--kv_heads 1] [--device cuda]
  python -m mt3_tpu_torch.bench --checkpoint runs/gqa_ft_torch/ckpt \
      --audio corpus/test
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as config_lib
from mt3_tpu_torch.device import describe, resolve_device
from mt3_tpu_torch.infer import decode
from mt3_tpu_torch.models import t5
from mt3_tpu_torch.ops import spectrogram

BASELINE_AUDIO_SEC_PER_SEC = 50.0  # north star: 50x real time per device

NUM_SEGMENTS = 1024
STEPS_PER_ITER = 16  # decode tokens between two all-done checks
WARMUP_ITERS = 1
TIMED_ITERS = 3


def _corpus_frames(data_dir, spec_config, inputs_length, num_segments):
  """Real held-out audio, framed and tiled to the bench batch."""
  from mt3_tpu_torch.data import datasets
  from mt3_tpu_torch.data import pipeline
  source = datasets.resolve_data_source(
      data_dir, spec_config, num_examples=num_segments)
  segs = []
  for ex in source.examples():
    frames, _ = pipeline.audio_to_frames(ex['audio'], spec_config)
    for start in range(0, len(frames) - inputs_length + 1, inputs_length):
      segs.append(frames[start:start + inputs_length])
      if len(segs) >= num_segments:
        break
    if len(segs) >= num_segments:
      break
  if not segs:
    raise SystemExit(
        f'no usable segments in --audio dir {data_dir!r}: need clips with '
        f'>= {inputs_length} frames ({inputs_length / spec_config.frames_per_second:.1f} s)')
  reps = -(-num_segments // len(segs))
  return np.concatenate([np.stack(segs)] * reps)[:num_segments]


def random_frames(spec_config, inputs_length, num_segments=None):
  """bench.py's default input: numpy seed 0, [segments, frames, hop]
  (NUM_SEGMENTS segments unless told otherwise)."""
  rng = np.random.RandomState(0)
  return rng.randn(num_segments or NUM_SEGMENTS, inputs_length,
                   spec_config.hop_width).astype(np.float32)


def model_config(kv_heads, base=None):
  """bench.py's decode configuration (bench.py:95-114) over `base` (mt3's
  model by default): bf16, int4 self-attention cache, int8 cross K/V, the
  stacked carry and `kv_heads` K/V heads (0: multi-head)."""
  base = base or config_lib.mt3_config().model
  return dataclasses.replace(
      base, dtype='bfloat16', decode_kv_quantize=True, decode_kv_bits=4,
      decode_cross_kv_quantize=True, decode_cache_carry='stacked',
      **({'num_kv_heads': kv_heads} if kv_heads else {}))


def make_transcribe(params, model_config, spec_config, run, forbid_eos,
                    steps_per_iter=STEPS_PER_ITER):
  """bench.py's device program: frames [b, frames, hop] -> (tokens,
  lengths) on the frames' device, `steps_per_iter` decode steps between
  two all-done checks."""

  def transcribe(frames):
    with torch.inference_mode():
      mel = spectrogram.compute_logmel(spectrogram.flatten_frames(frames),
                                       spec_config)
      encoded = t5.encode(params, model_config, mel)
      return decode.decode_tokens(
          params, model_config, encoded, run.targets_length,
          forbid_eos=forbid_eos, steps_per_iter=steps_per_iter)

  return transcribe


def time_passes(transcribe, frames, warmup=WARMUP_ITERS, timed=TIMED_ITERS):
  """Seconds of each timed pass after `warmup` untimed ones, and the last
  pass's tokens and lengths on the host.  Every pass copies its tokens to
  the host inside its timing, which waits for the device."""
  for _ in range(warmup):
    tokens, _ = transcribe(frames)
    tokens.cpu()
  seconds = []
  for _ in range(timed):
    start = time.perf_counter()
    tokens, lengths = transcribe(frames)
    tokens = tokens.cpu()
    seconds.append(time.perf_counter() - start)
  return seconds, tokens, lengths.cpu()


def result(seconds, audio_seconds_per_iter, n_devices, mean_len=None):
  """bench.py's JSON line from the timed passes' seconds."""
  seconds_per_iter = sum(seconds) / len(seconds)
  audio_sec_per_sec = audio_seconds_per_iter / seconds_per_iter
  per_chip = audio_sec_per_sec / max(1, n_devices)
  out = {
      'metric': 'audio_sec_transcribed_per_sec_per_chip',
      'value': round(per_chip, 3),
      'unit': 'audio_s/s/chip',
      'vs_baseline': round(per_chip / BASELINE_AUDIO_SEC_PER_SEC, 3),
  }
  if mean_len is not None:
    out['mode'] = 'trained+eos_exit'
    out['mean_decode_len'] = round(mean_len, 1)
  return out


def build_parser():
  parser = argparse.ArgumentParser()
  parser.add_argument('--checkpoint', default=None,
                      help='trained checkpoint dir: realistic mode '
                           '(real audio + EOS early exit) instead of '
                           'the random-weights worst case')
  parser.add_argument('--audio', default='corpus/validation',
                      help='corpus dir for --checkpoint mode audio')
  parser.add_argument('--kv_heads', type=int, default=1,
                      help='GQA KV heads for the decode config; the '
                           'default 1 is the production configuration. '
                           '0 = plain MHA.  A --checkpoint must be '
                           'shaped to match (runs/gqa_ft_torch/ckpt for '
                           '1, runs/mt3_flagship_torch/ckpt for 0)')
  parser.add_argument('--device', default=None,
                      help="'cuda' (the default) or 'cpu'")
  return parser


def main(argv=None):
  args = build_parser().parse_args(argv)

  device = resolve_device(args.device)
  print(describe(device), flush=True)
  config = config_lib.mt3_config()
  mc = model_config(args.kv_heads, config.model)
  spec_config = config.spectrogram
  run = config.run

  if args.checkpoint:
    from mt3_tpu_torch.train import checkpoint as ckpt_lib
    params, _ = ckpt_lib.load_params(args.checkpoint, mc)
    params = params_lib.to_device(params, device)
  else:
    params = params_lib.init_params(mc, device=device)

  seg_seconds = run.inputs_length / spec_config.frames_per_second
  audio_seconds_per_iter = NUM_SEGMENTS * seg_seconds

  if args.checkpoint:
    frames = _corpus_frames(args.audio, spec_config, run.inputs_length,
                            NUM_SEGMENTS).astype(np.float32)
  else:
    frames = random_frames(spec_config, run.inputs_length, NUM_SEGMENTS)
  frames = torch.from_numpy(frames).to(device)

  # Trained-weights mode lets the batched EOS early exit stop the decode
  # once every segment has finished; random-weights mode forbids EOS to
  # force the worst-case full-length decode.
  transcribe = make_transcribe(params, mc, spec_config, run,
                               forbid_eos=not args.checkpoint)
  seconds, _, lengths = time_passes(transcribe, frames)
  print('timed passes: ' + ', '.join(f'{s:.3f}' for s in seconds) + ' s',
        flush=True)
  n_devices = torch.cuda.device_count() if device.type == 'cuda' else 1
  mean_len = float(lengths.double().mean()) if args.checkpoint else None
  print(json.dumps(result(seconds, audio_seconds_per_iter, n_devices,
                          mean_len)))


if __name__ == '__main__':
  main()
