"""Faults and the control, planted underneath the timed path, to show that
the comparison catches them (gpubench/tests and gpubench/control.py;
never in a benchmark run).  Each is plant(ctx): it replaces attributes of
the program with ctx.patch before the cell's set-up, and the run undoes
them once its window has closed.

  token       one served token altered where it is produced
              (decode.decode_tokens' output)
  half_batch  serving: the second half of the rows left undecoded (PAD);
              training: the second half of the batch left out of the
              loss, the mean taken over the rest (the sum doubled)
  unchanged   training: a step that leaves the state as it was (the
              optimizer's update skipped)
  control     the reference in the next lower precision than the
              configuration's (fp8 for its bf16 activations,
              reference/model.py) put in the program's place; it draws
              the parameters from the seed itself and reads the raw
              inputs that the benchmark made.  Serving: each served
              token is the one the fp8 reference puts first at its
              position, teacher-forced over the program's tokens (so it
              need not decode).  Training: each step is the fp8
              reference's, its loss, parameters and Adafactor moments
              written where the program keeps its own.

These serve the kinds bulk, clip and train; another kind brings its own
in its mode file (CONTROL and FAULTS; see plant).
"""

from __future__ import annotations

import inspect

import torch

# Rows of a block of the serving control's reference.
CONTROL_BLOCK = 16


def token(ctx):
  from mt3_tpu_torch.infer import decode
  original = decode.decode_tokens

  def altered(*args, **kwargs):
    tokens, lengths = original(*args, **kwargs)
    tokens = tokens.clone()
    tokens[:, 3] = torch.where(tokens[:, 3] > 2, 3 + (tokens[:, 3] - 3 + 17)
                               % 1000, tokens[:, 3])
    return tokens, lengths

  ctx.patch(decode, 'decode_tokens', altered)


def half_batch_serve(ctx):
  from mt3_tpu_torch.infer import decode
  original = decode.decode_tokens

  def half(params, config, encoded, *args, **kwargs):
    rows = encoded.shape[0]
    tokens, lengths = original(params, config, encoded[:rows - rows // 2],
                               *args, **kwargs)
    pad = torch.zeros((rows // 2, tokens.shape[1]), dtype=tokens.dtype,
                      device=tokens.device)
    return (torch.cat([tokens, pad]),
            torch.cat([lengths, torch.zeros_like(lengths[:rows // 2])]))

  ctx.patch(decode, 'decode_tokens', half)


def half_batch_train(ctx):
  from mt3_tpu_torch.train import trainer
  original = trainer._loss_and_metrics

  def half(params, batch, *args, **kwargs):
    rows = batch['decoder_target_tokens'].shape[0]
    kept = {k: v[:rows - rows // 2] for k, v in batch.items()}
    total, metrics = original(params, kept, *args, **kwargs)
    return total * (rows / (rows - rows // 2)), metrics

  ctx.patch(trainer, '_loss_and_metrics', half)


def unchanged(ctx):
  from mt3_tpu_torch.train import adafactor
  ctx.patch(adafactor.Adafactor, 'step', lambda self, closure=None: None)


def control_serve(ctx):
  from mt3_tpu_torch.infer import decode
  from mt3_tpu_torch.ops import spectrogram

  from gpubench import serving, weights
  held = {}
  logmel, decode_tokens = spectrogram.compute_logmel, decode.decode_tokens
  forbid = inspect.signature(decode_tokens).parameters['forbid_eos'].default

  def keep_audio(samples, *args, **kwargs):
    held['audio'] = samples   # the raw audio of the batch about to decode
    return logmel(samples, *args, **kwargs)

  def control(*args, **kwargs):
    tokens, lengths = decode_tokens(*args, **kwargs)
    if 'params' not in held:
      held['params'] = weights.make(ctx.config['model'], ctx.seed, ctx.device)
    chosen = serving.control_tokens(
        held['params'], ctx.config, held['audio'][:tokens.shape[0]].float(),
        tokens, kwargs.get('forbid_eos', forbid), block=CONTROL_BLOCK)
    return (chosen.to(tokens.dtype),
            serving.served_lengths(chosen).to(lengths.dtype))

  ctx.patch(spectrogram, 'compute_logmel', keep_audio)
  ctx.patch(decode, 'decode_tokens', control)


def control_train(ctx):
  from mt3_tpu_torch.train import trainer

  from gpubench import weights
  from gpubench.reference import train as ref_train
  held = {}
  model_batch = trainer.model_batch
  moments = (('v_row', 'row'), ('v_col', 'col'), ('v_full', 'full'))

  def keep_batch(batch, *args, **kwargs):
    held['batch'] = batch     # the raw host batch about to be stepped on
    return model_batch(batch, *args, **kwargs)

  def step(self, batch):
    if 'reference' not in held:
      held['reference'] = ref_train.Steps(
          weights.leaves(weights.make(ctx.config['model'], ctx.seed,
                                      ctx.device)),
          ctx.config, ctx.seed, ctx.device, 'fp8',
          ctx.traffic['check_block_rows'])
    reference = held['reference']
    loss = reference.step(held['batch'])
    with torch.no_grad():
      for path, p in weights.leaves(self.state.params).items():
        p.copy_(reference.params[path])
        slot, ours = self.state.optimizer.state[p], reference.opt[path]
        for port_key, key in moments:
          if key in ours:
            slot[port_key] = ours[key].clone()
    return {'loss': torch.tensor(loss)}

  ctx.patch(trainer, 'model_batch', keep_batch)
  ctx.patch(trainer.Trainer, 'step', step)


FAULTS = {
    'bulk': {'token': token, 'half_batch': half_batch_serve},
    'clip': {'token': token, 'half_batch': half_batch_serve},
    'train': {'half_batch': half_batch_train, 'unchanged': unchanged},
}
CONTROL = {'bulk': control_serve, 'clip': control_serve,
           'train': control_train}


def plant(kind: str, name: str):
  """The plant `name` ('control' or a fault) of a cell of `kind`: from the
  tables above, or for another kind the CONTROL or FAULTS[name] of the
  cell's own mode module (spec.Cell.mode), which the run then uses."""
  if kind in CONTROL:
    return CONTROL[kind] if name == 'control' else FAULTS[kind][name]

  def from_mode(ctx):
    mode = ctx.cell.mode()
    (mode.CONTROL if name == 'control' else mode.FAULTS[name])(ctx)

  return from_mode
