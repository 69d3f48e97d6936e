"""The device's idle share of a decode step run without the profiler, in
%: 1 minus the device's busy time per traced decode step (the union of
every device operation's interval, kernels, copies and sets, inside the
traced window, over its steps) over the host's time per decode step
before the profiler ran (decode_tokens ending in a synchronise, over its
steps; serving.clean_decodes).

The profiler slows the host's dispatch by some microseconds a launch,
which stretches the traced window but not the device's operations, so
the traced window's own idle share would count the profiler's tax as
idle time; the busy time a step is taken from the trace, the step's
length from the clean units.  The traced steps sit around the middle of
the cache (the traffic's trace_from_index), so their busy time is that
of the mean step of a full decode.  Moves audio_s_per_s."""

from gpubench import serving

WRAP = {serving.DECODE_SPAN: 'sync'}


def read(r):
  session = r.sessions.get('decode')
  traced = len(r.counters.get('decode_indices', []))
  clean = serving.clean_decodes(r)
  if session is None or not traced or clean is None:
    return None
  seconds, steps = clean
  return 100.0 * (1.0 - (session.busy_s / traced) / (seconds / sum(steps)))
