"""Host milliseconds per decode step: the host clock around each
decode.decode_tokens call, ending in a device synchronise, over the steps
that call ran (counted by the harness's decode-step hook), summed over
the window's units that ran before the profiler.  Moves audio_s_per_s."""

from gpubench import serving

WRAP = {serving.DECODE_SPAN: 'sync'}


def read(r):
  clean = serving.clean_decodes(r)
  if clean is None:
    return None
  seconds, steps = clean
  return seconds / sum(steps) * 1e3
