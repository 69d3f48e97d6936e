"""Host milliseconds a train step spends making its batch into model
features: the program's 'train.batch' spans (trainer.model_batch: the
copies of the host batch to the device and kernel A's launch), median
over the spans that closed before the profiler ran.  Moves
train_tokens_per_s."""

from gpubench import program_spans

program_spans.start()


def read(r):
  return program_spans.host_ms('train.batch')
