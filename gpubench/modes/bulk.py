"""Bulk transcription: passes over a corpus of segments, back to back.

A closed loop of one caller.  Each pass takes the traffic's `segments`
random segments of the configuration's length (float32 audio frames,
standard normal, drawn once from the seed on the device) through the
port's device program as Transcriber._transcribe_batch composes it:
compute_logmel (kernel A) -> t5.encode -> decode.decode_tokens (kernel
B, `steps_per_check` steps between two all-done checks), with EOS
forbidden, so that every row decodes all targets_length tokens; the
tokens are fetched to the host.  The unit is a pass; its work is the
audio of its segments.
"""

from __future__ import annotations

import torch

from gpubench import harness, program, serving, weights

MAIN_SESSION = 'decode'


def setup(ctx):
  from mt3_tpu_torch.infer import decode
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.ops import spectrogram
  cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
  prog = program.config(cfg)
  mc, spec, run = prog.model, prog.spectrogram, prog.run
  params = weights.make(cfg['model'], ctx.seed, device)
  ctx.mark('parameters')
  gen = torch.Generator(device=device).manual_seed(
      harness.stream_seed(ctx.seed, 1))
  n, length, hop = traffic['segments'], run.inputs_length, spec.hop_width
  frames = torch.randn((n, length, hop), generator=gen, device=device)
  forbid_eos = traffic['forbid_eos']
  steps_per_check = traffic['steps_per_check']
  ctx.mark('inputs')
  program.load_kernels(ctx, ('logmel', 'decode_attention'))

  def transcribe():
    with torch.inference_mode():
      mel = spectrogram.compute_logmel(spectrogram.flatten_frames(frames),
                                       spec)
      encoded = t5.encode(params, mc, mel)
      tokens, _ = decode.decode_tokens(
          params, mc, encoded, run.targets_length, forbid_eos=forbid_eos,
          steps_per_iter=steps_per_check)
      return tokens.cpu()

  # Warm-up of the pass's shapes through the same layer functions: log-mel
  # and encoder at the full batch, the full-length caches, a check's worth
  # of decode steps and the all-done check.
  with torch.inference_mode():
    mel = spectrogram.compute_logmel(spectrogram.flatten_frames(frames), spec)
    encoded = t5.encode(params, mc, mel)
    state = t5.init_decode_state(params, mc, encoded, run.targets_length)
    token = torch.zeros((n,), dtype=torch.int32, device=device)
    for _ in range(steps_per_check + 1):
      logits, state = t5.decode_step(params, mc, token, state)
      token = torch.argmax(logits, dim=-1).to(torch.int32)
    bool((token == serving.EOS_ID).all())
    torch.full((n, run.targets_length), 0, dtype=torch.int32,
               device=device).cpu()
    del mel, encoded, state, token, logits
  ctx.mark('warm-up')
  serving.install_decode_trace(ctx, mc, n, length)
  return dict(ctx=ctx, params=params, frames=frames, transcribe=transcribe,
              seconds=n * length / spec.frames_per_second, tokens=[],
              forbid_eos=forbid_eos)


def unit(state, i):
  state['tokens'].append(state['transcribe']())
  return state['seconds']


def end_to_end(results, elapsed):
  return {'audio_s_per_s': sum(results) / elapsed}


def check(state, results):
  """Rows sampled from the seed across the window's passes, held against
  the reference."""
  ctx = state['ctx']
  traffic = ctx.traffic
  passes = state['tokens']
  frames = state['frames']
  rows = serving.sample(ctx.seed, [(p, r) for p in range(len(passes))
                                   for r in range(frames.shape[0])],
                        traffic['check_rows'])
  if ctx.cuda:
    torch.cuda.empty_cache()
  tokens = torch.stack([passes[p][r] for p, r in rows]).to(ctx.device)
  audio = torch.stack([frames[r].reshape(-1) for _, r in rows])
  ref = serving.reference_logits(state['params'], ctx.config, audio, tokens)
  gap = serving.gaps(ref, tokens, state['forbid_eos'])
  checks = [harness.Check('logit_gap', float(gap.max()),
                          ctx.limits.get('logit_gap', 0.0))]
  failed = int((gap.max(-1).values > checks[0].limit).sum())
  return checks, len(passes) * frames.shape[0], failed
