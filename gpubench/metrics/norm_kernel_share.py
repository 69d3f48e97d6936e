"""The share of layers.rms_norm's calls that took kernel D (the RMS-norm
kernel), in %: the program's counter norm.kernel_calls over norm.calls
(every layers.rms_norm call), over the whole traced run, set-up's
warm-up included.  0 where the program counts norms and no kernel call;
none where it counts no norms (a program without the counters).  Moves
train_tokens_per_s."""

from gpubench import program_spans

program_spans.start()


def read(r):
  calls = program_spans.counter('norm.calls')
  if not calls:
    return None
  kernel_calls = program_spans.counter('norm.kernel_calls') or 0
  return 100.0 * kernel_calls / calls
