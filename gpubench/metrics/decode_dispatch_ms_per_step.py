"""Host milliseconds per decode step that decode_tokens spends in its
steps: the program's 'decode.step' spans (t5.decode_step's launches, the
masking, the selection and the buffer write; the host blocks there when
the launch queue is full), summed over the calls that closed before the
profiler ran and over their steps, as decode_step_ms is: with
check_wait_ms_per_step it splits decode_step_ms.  Moves audio_s_per_s."""

from gpubench import program_spans

program_spans.start()


def read(r):
  return program_spans.per_decode_step('decode.step')
