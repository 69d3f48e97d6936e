"""Profiling and throughput instrumentation (mt3_tpu/utils/profiling.py
rebuilt on torch.profiler).

trace(log_dir) records the host and, where there is one, the CUDA device
under torch.profiler and writes a Chrome trace (trace.<pid>.<n>.json) into
log_dir, as the JAX package's trace writes an xplane.  Timer.elapsed(result)
waits for the CUDA streams that compute `result` before it reads the clock,
where the JAX package blocks until the result is ready.  ThroughputMeter is
the JAX package's (steps/s and audio-seconds/s over a sliding window).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Optional

import torch

_TRACES = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str):
  """Capture a torch.profiler trace around a code block; yields the
  profiler (its events() and key_averages() read the trace)."""
  from torch.profiler import ProfilerActivity, profile
  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  profiler = profile(activities=activities)
  profiler.start()
  try:
    yield profiler
  finally:
    profiler.stop()
    profiler.export_chrome_trace(os.path.join(
        log_dir, f'trace.{os.getpid()}.{next(_TRACES)}.json'))


def _cuda_devices(result) -> set:
  """The CUDA devices of the tensors in a tree of dicts, lists and tuples."""
  if torch.is_tensor(result):
    return {result.device} if result.device.type == 'cuda' else set()
  if isinstance(result, dict):
    result = list(result.values())
  if isinstance(result, (list, tuple)):
    return set().union(*(_cuda_devices(r) for r in result))
  return set()


class Timer:
  """Wall-clock timer; elapsed(result) first waits for the CUDA streams
  that compute the result's tensors."""

  def __init__(self):
    self.start = time.perf_counter()

  def elapsed(self, result=None) -> float:
    for device in _cuda_devices(result):
      torch.cuda.current_stream(device).synchronize()
    return time.perf_counter() - self.start


class ThroughputMeter:
  """Tracks steps/sec and audio-seconds/sec over a sliding window."""

  def __init__(self, window: int = 50):
    self.window = window
    self.times = []
    self.audio_seconds = []

  def update(self, audio_seconds: float = 0.0):
    self.times.append(time.perf_counter())
    self.audio_seconds.append(audio_seconds)
    if len(self.times) > self.window:
      self.times.pop(0)
      self.audio_seconds.pop(0)

  @property
  def steps_per_second(self) -> Optional[float]:
    if len(self.times) < 2:
      return None
    return (len(self.times) - 1) / (self.times[-1] - self.times[0])

  @property
  def audio_seconds_per_second(self) -> Optional[float]:
    if len(self.times) < 2:
      return None
    return sum(self.audio_seconds[1:]) / (self.times[-1] - self.times[0])
