"""Device milliseconds per decode step in which some operation ran: the
union of the device operations' intervals over the traced decode steps,
over those steps.  The profiler slows the host's dispatch, so the traced
window is longer than a step run without it; beside decode_step_ms
(measured before the profiler ran) this gives the device's idle share of
an untraced step.  Moves audio_s_per_s."""


def read(r):
  session = r.sessions.get('decode')
  steps = len(r.counters.get('decode_indices', []))
  if session is None or not steps:
    return None
  return session.busy_s / steps * 1e3
