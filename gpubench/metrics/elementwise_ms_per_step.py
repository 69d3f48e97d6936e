"""Device milliseconds per train step in kernels that KERNEL_KINDS puts in
none of kernels A, B, C or cuBLAS (elementwise ops, reductions, copies),
from the profiler's trace of the traced steps.  Moves train_tokens_per_s."""

from gpubench import work


def read(r):
  session = r.sessions.get('train')
  steps = r.counters.get('train_steps', 0)
  if session is None or not steps:
    return None
  return session.device_s(
      lambda name: work.kernel_kind(name) == work.ELEMENTWISE) / steps * 1e3
