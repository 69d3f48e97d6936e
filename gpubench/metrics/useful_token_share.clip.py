"""The share of the decode's row steps that the clips keep, in %: the
program's counter transcribe.tokens_kept (non-PAD tokens of the real rows,
counted on the host from the fetched tokens) over decode.row_steps (rows x
steps of every decode_tokens call), over the whole run.  A row that has
emitted EOS, and a row of batch padding, still costs its steps until the
batch's all-done check stops the decode.  Moves audio_s_per_s.clip."""

from gpubench import program_spans

program_spans.start()


def read(r):
  kept = program_spans.counter('transcribe.tokens_kept')
  steps = program_spans.counter('decode.row_steps')
  return 100.0 * kept / steps if kept is not None and steps else None
