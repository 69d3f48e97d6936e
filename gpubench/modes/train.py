"""Training: Trainer.step on a ring of staged host batches, back to back.

The flagship recipe's step (mt3_tpu_torch/tools/run_flagship.sh): bf16
activations, flash attention (kernel C), rematerialised layers, the
configuration's dropout, Adafactor, at the traffic's batch.  A ring of
`ring` distinct batches is drawn from the seed at set-up: raw audio
frames (float32, standard normal, drawn on the device and kept on the
host) and targets uniform over the codec's ids, as the port's
make_train_batch draws them.  Each step turns its host batch into model
features with trainer.model_batch (the copy to the device and kernel A,
as the recipe does) and calls Trainer.step, then waits for the device.

The first `check_steps` steps run at set-up through the same calls, on
the first batches of the ring; the comparison holds their losses, the
first gradient as the optimizer received it (from its state after one
step) and the parameters' change over them against the reference.  The
window continues the ring.  The unit is a step; its work is batch x
targets_length target tokens.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from gpubench import harness, program, weights
from gpubench.reference import train as ref_train

MAIN_SESSION = 'train'
# A leaf whose first reference gradient is under this share of the median
# leaf's moves under Adafactor by round-off alone: its change is not held.
STILL_LEAF = 1e-3


def batches(cfg, traffic, seed, device):
  spec, run = cfg['spectrogram'], cfg['run']
  b, length, targets = (traffic['batch'], run['inputs_length'],
                        run['targets_length'])
  gen = torch.Generator(device=device).manual_seed(
      harness.stream_seed(seed, 1))
  rng = np.random.default_rng(harness.stream_seed(seed, 2))
  ring = []
  for _ in range(traffic['ring']):
    frames = torch.randn((b, length, spec['hop_width']), generator=gen,
                         device=device).cpu().numpy()
    tokens = rng.integers(3, cfg['model']['vocab_size'], (b, targets),
                          dtype=np.int32)
    ring.append({
        'encoder_input_frames': frames,
        'decoder_target_tokens': tokens,
        'decoder_input_tokens': np.concatenate(
            [np.zeros((b, 1), np.int32), tokens[:, :-1]], axis=1),
        'decoder_loss_weights': (tokens > 0).astype(np.int32)})
  return ring


def grad_norms(trainer, paths):
  """Each leaf's first gradient norm, from Adafactor's state after one
  step: the second moments are then the squared gradient (+ 1e-30)."""
  from mt3_tpu_torch.train import adafactor
  out = {}
  for path, p in paths.items():
    slot = trainer.state.optimizer.state[p]
    if adafactor.factored(p.shape):
      total = slot['v_row'].double().sum() * p.shape[-1]
    else:
      total = slot['v_full'].double().sum()
    out[path] = float(torch.sqrt(torch.clamp(total - p.numel() * 1e-30,
                                             min=0.0)))
  return out


def setup(ctx):
  from mt3_tpu_torch.train import trainer as trainer_lib
  cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
  prog = program.config(cfg, remat=traffic['remat'],
                        remat_policy=traffic['remat_policy'],
                        train_attention_impl=traffic['attention'])
  params = weights.make(cfg['model'], ctx.seed, device)
  ctx.mark('parameters')
  ring = batches(cfg, traffic, ctx.seed, device)
  ctx.mark('inputs')
  trainer = trainer_lib.Trainer(prog.model, prog.run, seed=ctx.seed,
                                device=device)
  trainer.load_params(params)
  ctx.mark('trainer')
  program.load_kernels(ctx, ('logmel', 'flash_attention_tc'))
  paths = weights.leaves(trainer.state.params)

  def step(k):
    batch = trainer_lib.model_batch(ring[k % len(ring)], prog.spectrogram,
                                    device)
    metrics = trainer.step(batch)
    ctx.sync()
    return metrics

  losses, first = [], None
  for k in range(traffic['check_steps']):
    losses.append(float(step(k)['loss']))
    if first is None:
      first = grad_norms(trainer, paths)
  after = {path: p.detach().clone() for path, p in paths.items()}
  ctx.mark('check steps (the warm-up)')
  ctx.counters.update(batch=traffic['batch'], train_steps=0,
                      frames=cfg['run']['inputs_length'],
                      targets=cfg['run']['targets_length'])
  return dict(ctx=ctx, trainer=trainer, params=params, ring=ring, step=step,
              losses=losses, first=first, after=after,
              tokens=traffic['batch'] * cfg['run']['targets_length'])


def unit(state, i):
  """One step; in a traced run the traced unit and the next in session
  'train' (device operations and runtime calls), the one after in
  'train_host', which also records the host's operator calls, for the
  idle gaps' labels."""
  ctx = state['ctx']
  at = None if ctx.trace_unit is None else i - ctx.trace_unit
  if at in (0, 2):
    ctx.tracer.start('train' if at == 0 else 'train_host', host=at == 2)
  state['step'](ctx.traffic['check_steps'] + i)
  if at in (0, 1):
    ctx.counters['train_steps'] += 1
  if at in (1, 2):
    ctx.tracer.stop()
  return state['tokens']


def end_to_end(results, elapsed):
  return {'train_tokens_per_s': sum(results) / elapsed}


def _worst(got, want, paths):
  scale = statistics.median(want[p] for p in paths)
  return max(abs(got[p] - want[p]) / max(want[p], scale) for p in paths)


def check(state, results):
  """The check steps' losses, first gradient and change against the
  reference's."""
  ctx = state['ctx']
  del state['trainer'], state['step']
  if ctx.cuda:
    torch.cuda.empty_cache()
  params = weights.leaves(state['params'])
  steps = ctx.traffic['check_steps']
  losses, grads, after = ref_train.steps(
      params, ctx.config, state['ring'][:steps], ctx.seed, ctx.device,
      block=ctx.traffic['check_block_rows'])
  scale = statistics.median(grads.values())
  moving = [p for p in params if grads[p] >= STILL_LEAF * scale]
  if len(moving) < len(params):
    harness.log(f"leaves left out of change_gap (first gradient under "
                f"{STILL_LEAF} of the median leaf's): "
                f"{sorted(set(params) - set(moving))}")
  change = {p: float((after[p] - params[p]).norm()) for p in params}
  got_change = {p: float((state['after'][p] - params[p]).norm())
                for p in params}
  readings = {
      'loss_gap': max(abs(g - w) / abs(w)
                      for g, w in zip(state['losses'], losses)),
      'grad_gap': _worst(state['first'], grads, list(params)),
      'change_gap': _worst(got_change, change, moving)}
  harness.log(f"losses: program {state['losses']}, reference {losses}")
  checks = [harness.Check(name, value, ctx.limits.get(name, 0.0))
            for name, value in readings.items()]
  return checks, len(results), sum(not c.ok for c in checks)
