"""Host milliseconds per decode step that decode_tokens spends in its
all-done checks: the program's 'decode.done_check' spans (bool(done.all()),
which waits for every step launched before it), summed over the calls
that closed before the profiler ran and over their steps, as
decode_step_ms is: with decode_dispatch_ms_per_step it splits
decode_step_ms.  Moves audio_s_per_s."""

from gpubench import program_spans

program_spans.start()


def read(r):
  return program_spans.per_decode_step('decode.done_check')
