"""Kernel launches the host makes per decode step: the CUDA runtime and
driver launch calls (cudaLaunchKernel and its kin, graph launches) in the
profiler's host trace of the traced decode steps, over those steps.  What
the host pays per step; a CUDA graph or a fusion lowers it.  Moves
audio_s_per_s."""


def read(r):
  session = r.sessions.get('decode')
  steps = len(r.counters.get('decode_indices', []))
  if session is None or not steps:
    return None
  return session.launches / steps
