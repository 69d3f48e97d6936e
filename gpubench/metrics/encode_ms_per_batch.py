"""Device milliseconds from the start of compute_logmel (kernel A) to the
end of t5.encode for one segment batch, by CUDA events recorded around
the two calls, median over the batches of the window's units that ran
before the profiler.  Moves audio_s_per_s."""

import statistics

WRAP = {'mt3_tpu_torch.ops.spectrogram.compute_logmel': 'events',
        'mt3_tpu_torch.models.t5.encode': 'events'}


def read(r):
  if r.spans is None:
    return None
  parts = [r.spans.values(name, 'device_s') for name in WRAP]
  if not all(parts):
    return None
  return sum(statistics.median(p) for p in parts) * 1e3
