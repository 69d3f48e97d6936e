"""Device milliseconds a train step spends after the backward pass: the
data sum, grad_norm, Adafactor and param_norm, by the CUDA events of the
program's 'train.optimizer' spans, median over the steps that closed
before the profiler ran.  Moves train_tokens_per_s."""

from gpubench import program_spans

program_spans.start()


def read(r):
  return program_spans.device_ms_per_train_step('train.optimizer')
