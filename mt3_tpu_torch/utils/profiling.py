"""The port's instrumentation: a recorder of spans and counters, and
torch.profiler traces (mt3_tpu/utils/profiling.py rebuilt on
torch.profiler).

The recorder is off by default.  Off, span() returns a shared null
context and count() returns, each after one boolean test: nothing is
allocated, no record_function is entered and no CUDA event is made.
enable() turns it on.  Then

  with span('decode.step'): ...                 # host clock
  with span('encode', device=x.device): ...     # and CUDA events
  count('decode.row_steps', rows * steps)

record each span's name, id, parent (the innermost span open on the same
thread), root (the outermost one: the spans of one transcribe call or one
train step share it), start and end on time.perf_counter_ns(), and
after_profiler.  That flag is sticky: it is set on every span that closes
once any span has opened or closed while a torch profiler ran, since the
profiler slows the host for the rest of the process.  While a profiler
runs, a span also enters torch.profiler.record_function(name), so that
it lies on the trace's timeline beside the device's operations (unless
annotate=False).  A span with device=True (the current CUDA device) or a
CUDA torch.device also records a pair of timing CUDA events on that
device's current stream; nothing waits for them until collect().  On the
CPU it records host time only.  Counters add host integers: no count
waits for the device.

The newest MAX_RECORDS spans are kept in memory; `dropped` counts the
others.  collect() returns {'spans': [...], 'counters': {...}, 'kernels':
ops.launch_counts(), 'dropped': n}; each span is a dict with its
self_ns, its duration less its children's.

trace(log_dir) records the host and, where there is one, the CUDA device
under torch.profiler and writes a Chrome trace (trace.<pid>.<n>.json)
into log_dir, as the JAX package's trace writes an xplane.  It turns the
recorder on for its block and writes the block's spans beside the trace
(spans.<pid>.<n>.json, Chrome trace events on the trace's clock, aligned
by a span that both record), to be opened over it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch

MAX_RECORDS = 200_000
TRACE_MARK = 'profiling.trace'

_ON = False
_NULL = contextlib.nullcontext()
_TRACES = itertools.count()


class _Recorder:
  """The records, counters and per-thread span stacks of the process."""

  def __init__(self):
    self.lock = threading.Lock()
    self.ids = itertools.count(1)
    self.local = threading.local()
    self.clear()

  def clear(self, max_records: int = MAX_RECORDS) -> None:
    with self.lock:
      self.records = collections.deque(maxlen=max_records)
      self.counters = {}
      self.dropped = 0
      self.after_profiler = False

  def stack(self) -> list:
    local = self.local
    if not hasattr(local, 'stack'):
      local.stack, local.tid = [], threading.get_native_id()
    return local.stack

  def add(self, record) -> None:
    with self.lock:
      if len(self.records) == self.records.maxlen:
        self.dropped += 1
      self.records.append(record)

  def count(self, name: str, n: int) -> None:
    with self.lock:
      self.counters[name] = self.counters.get(name, 0) + n


_RECORDER = _Recorder()


def _stream(device):
  """The CUDA stream a device span records its events on, or None."""
  if device is True:
    return (torch.cuda.current_stream() if torch.cuda.is_available()
            and torch.cuda.is_initialized() else None)
  if isinstance(device, torch.device) and device.type == 'cuda':
    return torch.cuda.current_stream(device)
  return None


class _Span:
  """One span while it is open; its own record once closed."""
  __slots__ = ('name', 'id', 'parent', 'root', 'tid', 'start_ns', 'end_ns',
               'after_profiler', 'device', '_stream', '_annotate',
               '_annotation')

  def __init__(self, name: str, device, annotate: bool):
    self.name = name
    self._stream = _stream(device)
    self._annotate = annotate

  def __enter__(self):
    rec = _RECORDER
    stack = rec.stack()
    self.id = next(rec.ids)
    self.parent = stack[-1] if stack else None
    self.root = stack[0] if stack else self.id
    self.tid = rec.local.tid
    stack.append(self.id)
    self._annotation = None
    profiled = torch.autograd._profiler_enabled()
    if profiled:
      rec.after_profiler = True
    self.start_ns = time.perf_counter_ns()
    if profiled and self._annotate:
      self._annotation = torch.profiler.record_function(self.name)
      self._annotation.__enter__()
    if self._stream is not None:
      self.device = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
      self.device[0].record(self._stream)
    else:
      self.device = None
    return self

  def __exit__(self, *exc):
    rec = _RECORDER
    if self.device is not None:
      self.device[1].record(self._stream)
    if self._annotation is not None:
      self._annotation.__exit__(None, None, None)
    self.end_ns = time.perf_counter_ns()
    if torch.autograd._profiler_enabled():
      rec.after_profiler = True
    self.after_profiler = rec.after_profiler
    self._stream = self._annotation = None
    rec.stack().pop()
    rec.add(self)
    return False


def span(name: str, device=False, annotate: bool = True):
  """A context manager that records a span while the recorder is on.

  device: False (host clock only), True (also CUDA events on the current
  CUDA device's current stream, where CUDA is in use) or a torch.device
  (events where it is a CUDA device).
  annotate=False keeps the span off a running profiler's timeline: for a
  span around a call that may stop one profiler session and start
  another (the benchmark's decode-step hook does, in t5.decode_step).  An
  annotation entered under one session and closed under the next writes
  into the first session's freed records.
  """
  if not _ON:
    return _NULL
  return _Span(name, device, annotate)


def count(name: str, n: int = 1) -> None:
  """Adds n to counter `name` while the recorder is on."""
  if not _ON:
    return
  _RECORDER.count(name, n)


def enable() -> None:
  global _ON
  _ON = True


def disable() -> None:
  global _ON
  _ON = False


def enabled() -> bool:
  return _ON


def reset() -> None:
  """Forgets every record and counter, and the profiler having run."""
  _RECORDER.clear()


def collect() -> dict:
  """The records kept so far, oldest first, with each device span's
  device_ms (waiting for its events here), the counters, the kernels'
  launch counters and how many records were dropped."""
  from mt3_tpu_torch import ops
  rec = _RECORDER
  with rec.lock:
    records = list(rec.records)
    counters = dict(rec.counters)
    dropped = rec.dropped
  children = collections.Counter()
  for r in records:
    if r.parent is not None:
      children[r.parent] += r.end_ns - r.start_ns
  spans = []
  for r in records:
    if isinstance(r.device, tuple):
      start, end = r.device
      end.synchronize()
      r.device = start.elapsed_time(end)
    spans.append({'name': r.name, 'id': r.id, 'parent': r.parent,
                  'root': r.root, 'tid': r.tid, 'start_ns': r.start_ns,
                  'end_ns': r.end_ns,
                  'self_ns': r.end_ns - r.start_ns - children[r.id],
                  'after_profiler': r.after_profiler, 'device_ms': r.device})
  return {'spans': spans, 'counters': counters,
          'kernels': ops.launch_counts(), 'dropped': dropped}


def _write_spans(trace_path: str, path: str, mark: _Span) -> None:
  """The spans opened from `mark` on, as Chrome trace events on the
  clock of the trace at trace_path, where `mark` lies."""
  with open(trace_path) as f:
    events = json.load(f)['traceEvents']
  at = [e['ts'] for e in events
        if e.get('name') == TRACE_MARK and e.get('ph') == 'X']
  offset_us = float(at[0]) - mark.start_ns / 1e3 if at else None
  got = collect()
  out = [{'name': s['name'], 'ph': 'X', 'cat': 'program_span',
          'ts': (s['start_ns'] / 1e3 + (offset_us or 0.0)),
          'dur': (s['end_ns'] - s['start_ns']) / 1e3, 'pid': os.getpid(),
          'tid': s['tid'],
          'args': {k: s[k] for k in ('id', 'parent', 'root', 'device_ms')}}
         for s in got['spans'] if s['id'] >= mark.id]
  with open(path, 'w') as f:
    json.dump({'traceEvents': out,
               'clock': 'trace' if at else 'perf_counter_ns / 1e3',
               'counters': got['counters'], 'kernels': got['kernels'],
               'dropped': got['dropped']}, f)


@contextlib.contextmanager
def trace(log_dir: str):
  """Capture a torch.profiler trace around a code block, with the
  program's spans on; yields the profiler (its events() and
  key_averages() read the trace)."""
  from torch.profiler import ProfilerActivity, profile
  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  stem = f'{os.getpid()}.{next(_TRACES)}.json'
  was_on = _ON
  enable()
  profiler = profile(activities=activities)
  profiler.start()
  try:
    with span(TRACE_MARK) as mark:
      pass
    yield profiler
  finally:
    profiler.stop()
    if not was_on:
      disable()
    trace_path = os.path.join(log_dir, 'trace.' + stem)
    profiler.export_chrome_trace(trace_path)
    _write_spans(trace_path, os.path.join(log_dir, 'spans.' + stem), mark)
