"""Device milliseconds a train step spends in the backward pass, with
remat's recomputation: the CUDA events of the program's 'train.backward'
spans, summed over the step, median over the steps that closed before
the profiler ran.  Moves train_tokens_per_s."""

from gpubench import program_spans

program_spans.start()


def read(r):
  return program_spans.device_ms_per_train_step('train.backward')
