"""Kernel A's share of its roofline on the first segment batch, in %.

work.logmel_work (an FFT log-mel's operations and bytes, with the mel
filterbank's nonzeros counted from the reference's matrix) against the
published float32 peak and 3.35 TB/s, the larger of the two times, over
the device time of logmel_fft_kernel in the profiled log-mel call.
Operations bound it at these shapes.  Moves audio_s_per_s."""

from gpubench import work
from gpubench.reference import logmel


def read(r):
  session = r.sessions.get('logmel')
  shape = r.counters.get('logmel_samples')
  if session is None or not shape:
    return None
  device_s = session.device_s(lambda n: 'logmel_fft_kernel' in n)
  if device_s <= 0:
    return None
  spec = r.config['spectrogram']
  batch = 1
  for size in shape[:-1]:
    batch *= size
  flops, nbytes = work.logmel_work(
      spec['fft_size'], spec['hop_width'], spec['num_mel_bins'], batch,
      shape[-1], work.mel_nonzeros(logmel.spec_mel_matrix(spec)))
  return 100.0 * work.bound(flops, nbytes)[0] / (device_s * 1e3)
