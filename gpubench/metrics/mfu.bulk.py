"""The decode steps' share of the chip's bf16 peak, in %: the model FLOPs
of every decode_tokens call in the window's units that ran before the
profiler (work.decode_step_flops at each of its steps' cache index,
every row of the batch) over the host's time of those calls, each ending
in a synchronise (serving.clean_decodes), x 989 TFLOP/s.  Read without
the profiler, whose tax on each launch would lengthen the time.  Bounds
what a kernel's roofline can claim.  Moves audio_s_per_s."""

from gpubench import serving, work

WRAP = {serving.DECODE_SPAN: 'sync'}


def read(r):
  clean = serving.clean_decodes(r)
  if clean is None:
    return None
  seconds, steps = clean
  flops = sum(work.decode_step_flops(r.config['model'], r.counters['rows'],
                                     index, r.counters['frames'])
              for n in steps for index in range(n))
  return 100.0 * flops / (seconds * work.PEAK_BF16_FLOPS)
