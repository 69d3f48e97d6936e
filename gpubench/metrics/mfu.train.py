"""The traced train steps' share of the chip's bf16 peak, in %: the model
FLOPs of those steps (work.train_step_flops: 3x the forward, counted per
layer from shapes, recomputation not counted) over the traced window's
wall time x 989 TFLOP/s.  Moves train_tokens_per_s."""

from gpubench import work


def read(r):
  session = r.sessions.get('train')
  steps = r.counters.get('train_steps', 0)
  if session is None or not steps or session.window_s <= 0:
    return None
  flops = steps * work.train_step_flops(r.config['model'], r.counters['batch'],
                                        r.counters['targets'],
                                        r.counters['frames'])
  return 100.0 * flops / (session.window_s * work.PEAK_BF16_FLOPS)
