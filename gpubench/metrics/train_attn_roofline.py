"""Kernel C's share of its roofline over the traced train steps, in %.

For every attention call of a step at its shapes and causality (the
encoder's self-attention, the decoder's causal self-attention and its
cross-attention, in every layer), the least time of the forward and of
the whole backward once each (work.flash_work, bf16 products against 989
TFLOP/s and 3.35 TB/s, each the larger of its two times), over the
device time of the flash kernels in those steps.  Recomputation under
remat is work the inputs do not need, so it is not counted.  Moves
train_tokens_per_s."""

from gpubench import work

KERNELS = ('flash_fwd', 'flash_bwd_')


def least_ms_per_step(m, batch, frames, targets, elt):
  calls = ([(frames, frames, False)] * m['num_encoder_layers']
           + [(targets, targets, True), (targets, frames, False)]
           * m['num_decoder_layers'])
  total = 0.0
  for lq, lk, causal in calls:
    entries = work.flash_work(batch, m['num_heads'], lq, lk, m['head_dim'],
                              causal, elt)
    total += sum(work.bound(*entries[e], work.PEAK_BF16_FLOPS)[0]
                 for e in ('fwd', 'bwd'))
  return total


def read(r):
  session = r.sessions.get('train')
  steps = r.counters.get('train_steps', 0)
  if session is None or not steps:
    return None
  device_s = session.device_s(lambda n: any(k in n for k in KERNELS))
  if device_s <= 0:
    return None
  elt = 2 if r.config['dtype'] == 'bfloat16' else 4
  least = steps * least_ms_per_step(r.config['model'], r.counters['batch'],
                                    r.counters['frames'],
                                    r.counters['targets'], elt)
  return 100.0 * least / (device_s * 1e3)
