"""Bulk decoding of the tiny_other family (CPU tests), copied into a
throwaway root as gpubench/modes/tiny_other_bulk.py.

Passes over `segments` segments of seeded features, each encoded by the
port's T5 and decoded greedily through its cache for the configuration's
`targets_length` steps, every id allowed; a row serves up to and with the
family's end id.  The unit is a pass.  The control and the faults are
this kind's own (CONTROL, FAULTS).
"""

from __future__ import annotations

import torch

from gpubench import harness, serving

MAIN_SESSION = 'decode'


def serve(params, mc, features, length):
  """[b, length] int32 tokens of the port's encoder and greedy decode."""
  from mt3_tpu_torch.models import t5
  with torch.inference_mode():
    encoded = t5.encode(params, mc, features)
    state = t5.init_decode_state(params, mc, encoded, length)
    token = torch.zeros((features.shape[0],), dtype=torch.int32,
                        device=features.device)
    out = []
    for _ in range(length):
      logits, state = t5.decode_step(params, mc, token, state)
      token = torch.argmax(logits, dim=-1).to(torch.int32)
      out.append(token)
    return torch.stack(out, 1)


def setup(ctx):
  cfg, family = ctx.config, ctx.cell.family()
  mode = ctx.cell.mode()
  mc = family.model_config(cfg)
  params = family.make_weights(cfg, ctx.seed, ctx.device)
  gen = torch.Generator(device=ctx.device).manual_seed(
      harness.stream_seed(ctx.seed, 1))
  features = torch.randn(
      (ctx.traffic['segments'], cfg['run']['inputs_length'], mc.input_depth),
      generator=gen, device=ctx.device)
  length = cfg['run']['targets_length']
  mode.serve(params, mc, features, length)   # warm-up of the pass's shapes
  ctx.mark('warm-up')
  return dict(ctx=ctx, params=params, features=features, tokens=[],
              run=lambda: mode.serve(params, mc, features, length).cpu())


def unit(state, i):
  ctx = state['ctx']
  if (ctx.trace and i == ctx.trace_unit
      and 'decode' not in ctx.tracer.sessions):
    ctx.counters['rows'] = state['features'].shape[0]
    with ctx.tracer.session('decode'):
      state['tokens'].append(state['run']())
  else:
    state['tokens'].append(state['run']())
  return state['features'].shape[0]


def end_to_end(results, elapsed):
  return {'rows_per_s.tiny_other': sum(results) / elapsed}


def check(state, results):
  """Rows sampled from the seed across the passes, held against the
  family's reference under the family's ids."""
  ctx = state['ctx']
  family, features = ctx.cell.family(), state['features']
  passes = state['tokens']
  rows = serving.sample(ctx.seed, [(p, r) for p in range(len(passes))
                                   for r in range(features.shape[0])],
                        ctx.traffic['check_rows'])
  tokens = torch.stack([passes[p][r] for p, r in rows])
  ref = family.reference_logits(state['params'], ctx.config,
                                torch.stack([features[r] for _, r in rows]),
                                tokens)
  gap = serving.gaps(ref, tokens, False, **family.ids(ctx.config))
  limit = ctx.limits.get('logit_gap', 0.0)
  failed = int((gap.max(-1).values > limit).sum())
  return ([harness.Check('logit_gap', float(gap.max()), limit)],
          len(passes) * features.shape[0], failed)


def control(ctx):
  """The family's reference in fp8 in the program's place: at each
  position of the program's tokens, teacher-forced over them, the allowed
  id that it puts first."""
  mode, family = ctx.cell.mode(), ctx.cell.family()
  original = mode.serve

  def fp8(params, mc, features, length):
    tokens = original(params, mc, features, length)
    logits = family.reference_logits(params, ctx.config, features, tokens,
                                     'fp8')
    logits[..., list(family.ids(ctx.config)['never'])] = float('-inf')
    return logits.argmax(-1).to(tokens.dtype)

  ctx.patch(mode, 'serve', fp8)


def token(ctx):
  """One served token altered where it is produced."""
  mode = ctx.cell.mode()
  original = mode.serve

  def altered(*args):
    tokens = original(*args).clone()
    vocab = ctx.config['model']['vocab_size']
    tokens[:, 3] = (tokens[:, 3] + 7) % vocab
    return tokens

  ctx.patch(mode, 'serve', altered)


def half_batch(ctx):
  """The second half of the rows left undecoded (id 0)."""
  mode = ctx.cell.mode()
  original = mode.serve

  def half(params, mc, features, length):
    rows = features.shape[0]
    tokens = original(params, mc, features[:rows - rows // 2], length)
    return torch.cat([tokens, torch.zeros_like(tokens[:rows // 2])])

  ctx.patch(mode, 'serve', half)


CONTROL = control
FAULTS = {'token': token, 'half_batch': half_batch}
