"""What the two serving modes share: the decode-step trace and the check
of served tokens against the reference's logits.

The check (a served model): for each sampled row, the reference runs once
over the row's audio with the row's served tokens as decoder inputs, and
the number compared is the widest gap by which a served token's logit
lies below the reference's best allowed token (PAD never, EOS not under
forbid_eos), over every served position (up to and with an EOS).  The
control (gpubench/faults.py) serves, at each position of the program's
tokens, the token that the reference computed in the next lower
precision puts first (control_tokens).

MT3's ids are the defaults: the end id EOS_ID and the never-served ids
(PAD_ID,).  A mode of another family passes its own as `end_id` and
`never`.
"""

from __future__ import annotations

import torch

from gpubench import harness
from gpubench.reference import logmel as ref_logmel
from gpubench.reference import model as ref_model

PAD_ID, EOS_ID = 0, 1
NOT_ALLOWED = 1e9   # the gap of a token the program may never serve
HOST_STEPS = 8      # decode steps traced with the host's operator calls


def install_decode_trace(ctx, model, rows, frames):
  """In a traced run: wrap decode.decode_tokens, t5.decode_step and
  compute_logmel, and in the traced unit profile its first log-mel call
  (session 'logmel'), `trace_steps` decode steps of its first decode from
  cache index `trace_from_index` (session 'decode') and HOST_STEPS more
  with the host's calls (session 'decode_host').  Counts the steps of
  every decode, by unit.  `model` is the port's model configuration as
  it runs: the cache's bits and the activations' width come from it."""
  if not ctx.trace:
    return
  from mt3_tpu_torch.infer import decode
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.ops import spectrogram
  first = ctx.traffic['trace_from_index']
  steps = ctx.traffic['trace_steps']
  count = {'index': 0}
  indices, per_decode = [], []
  ctx.counters.update(
      rows=rows, frames=frames, decode_indices=indices,
      steps_per_decode=per_decode,
      kv_bits=model.decode_kv_bits if model.decode_kv_quantize else None,
      elt=2 if model.dtype == 'bfloat16' else 4, logmel_samples=None)
  decode_tokens, step, logmel = (decode.decode_tokens, t5.decode_step,
                                 spectrogram.compute_logmel)

  def counted_decode(*args, **kwargs):
    count['index'] = 0
    out = decode_tokens(*args, **kwargs)
    per_decode.append((ctx.unit, count['index']))
    return out

  # Steps [first, first + steps) in session 'decode' (device operations
  # and runtime calls), then HOST_STEPS more in 'decode_host', which also
  # records the host's operator calls, for the idle gaps' labels.
  plan = {first: ('decode', False), first + steps: ('decode_host', True),
          first + steps + HOST_STEPS: None}

  def decode_step(*args, **kwargs):
    index = count['index']
    if (index in plan and ctx.unit == ctx.trace_unit
        and 'decode_host' not in ctx.tracer.sessions):
      if ctx.tracer.active:
        ctx.tracer.stop()
      if plan[index] is not None:
        ctx.tracer.start(*plan[index])
    if ctx.tracer.open_name == 'decode':
      indices.append(index)
    count['index'] = index + 1
    return step(*args, **kwargs)

  def compute_logmel(samples, *args, **kwargs):
    if (ctx.unit != ctx.trace_unit or 'logmel' in ctx.tracer.sessions
        or ctx.tracer.active):
      return logmel(samples, *args, **kwargs)
    ctx.counters['logmel_samples'] = tuple(samples.shape)
    with ctx.tracer.session('logmel'):
      return logmel(samples, *args, **kwargs)

  ctx.patch(decode, 'decode_tokens', counted_decode)
  ctx.patch(t5, 'decode_step', decode_step)
  ctx.patch(spectrogram, 'compute_logmel', compute_logmel)


DECODE_SPAN = 'mt3_tpu_torch.infer.decode.decode_tokens'


def clean_decodes(r):
  """(host seconds, [steps of each decode]) of the decode_tokens calls in
  the window's units that ran before the profiler: the host clock around
  each call ends in a device synchronise (a reader's WRAP of DECODE_SPAN
  with 'sync').  None where there is none."""
  if r.spans is None:
    return None
  seconds = sum(r.spans.values(DECODE_SPAN, 'host_s'))
  steps = [n for unit, n in r.counters.get('steps_per_decode', [])
           if r.spans.clean(unit)]
  return (seconds, steps) if sum(steps) and seconds > 0 else None


def reference_logits(params, cfg, audio, tokens, prec='float32', block=4):
  """Teacher-forced reference logits [r, T, V] for rows of raw audio
  [r, samples] and their served tokens [r, T]."""
  out = []
  with torch.no_grad():
    for s in range(0, audio.shape[0], block):
      mel = ref_logmel.logmel(audio[s:s + block], cfg['spectrogram'])
      enc = ref_model.encode(params, cfg['model'], mel, prec)
      out.append(ref_model.decode(params, cfg['model'], enc,
                                  ref_model.shift_right(tokens[s:s + block]),
                                  prec))
  return torch.cat(out)


def _allowed(logits, forbid_eos, *, end_id=EOS_ID, never=(PAD_ID,)):
  logits = logits.clone()
  for token in never:
    logits[..., token] = float('-inf')
  if forbid_eos:
    logits[..., end_id] = float('-inf')
  return logits


def served_lengths(tokens, *, end_id=EOS_ID):
  """Served tokens per row: up to and with the first end id, else all."""
  is_eos = tokens == end_id
  first = torch.argmax(is_eos.to(torch.int32), dim=-1)
  return torch.where(is_eos.any(-1), first + 1,
                     torch.full_like(first, tokens.shape[-1]))


def gaps(ref_logits, tokens, forbid_eos, chosen=None, *, end_id=EOS_ID,
         never=(PAD_ID,)):
  """Per-position gap [r, T] of `chosen` (default: the served tokens)
  below the reference's best allowed token; 0 past each row's end."""
  allowed = _allowed(ref_logits, forbid_eos, end_id=end_id, never=never)
  best = allowed.max(-1).values
  chosen = tokens if chosen is None else chosen
  picked = allowed.gather(-1, chosen.to(torch.long)[..., None])[..., 0]
  gap = torch.where(torch.isfinite(picked), best - picked,
                    torch.full_like(best, NOT_ALLOWED))
  lengths = served_lengths(tokens, end_id=end_id)
  live = torch.arange(tokens.shape[-1], device=tokens.device)[None] < (
      lengths[:, None])
  return torch.where(live, gap, torch.zeros_like(gap))


def control_tokens(params, cfg, audio, tokens, forbid_eos, prec='fp8',
                   block=16):
  """[r, T]: at each position of `tokens`, teacher-forced over them, the
  allowed token that the reference in `prec` puts first."""
  out = []
  for s in range(0, audio.shape[0], block):
    logits = reference_logits(params, cfg, audio[s:s + block],
                              tokens[s:s + block], prec, block)
    out.append(_allowed(logits, forbid_eos).argmax(-1))
    del logits
  return torch.cat(out)


def sample(seed, population, k):
  """k distinct items of `population`, drawn from the seed."""
  import numpy as np
  rng = np.random.default_rng(harness.stream_seed(seed, 99))
  k = min(k, len(population))
  return [population[i] for i in sorted(rng.choice(len(population), k,
                                                   replace=False))]
