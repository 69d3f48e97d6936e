"""The run's frame: the window, spans, traces, the result line.

Nothing here imports the program.  A mode (gpubench/modes/<kind>.py)
builds the program's state, warms it up, runs one unit of work at a
time, and compares what the window produced with the reference; this
module times the window, records spans and profiler sessions, reads the
per-layer metrics from them and prints the result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mt3_tpu')
DEVICE_OPS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_MARKS = ('LaunchKernel', 'GraphLaunch')
GIB = 2**30


def log(msg: str) -> None:
  print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> List[str]:
  """Top-level names of loaded modules that the benchmark must not load,
  compared whole: mt3_tpu_torch is not mt3_tpu."""
  names = sys.modules if names is None else names
  return sorted({name.split('.')[0] for name in names} & set(FORBIDDEN))


def stream_seed(seed: int, stream: int) -> int:
  """An independent 63-bit seed for stream `stream` of run seed `seed`."""
  import numpy as np
  words = np.random.SeedSequence([seed, stream]).generate_state(2, np.uint32)
  return (int(words[0]) << 32 | int(words[1])) & (2**63 - 1)


def window(unit: Callable[[int], object], seconds: float,
           clock=time.perf_counter):
  """Runs unit(0), unit(1), ... back to back from the window's start until
  the first unit that ends at or after `seconds`.  Each unit returns
  after its work is complete.  Returns (elapsed seconds, results)."""
  start = clock()
  results = []
  while True:
    results.append(unit(len(results)))
    elapsed = clock() - start
    if elapsed >= seconds:
      return elapsed, results


def merged(intervals, lo, hi):
  """The union of (start, end) intervals clipped to [lo, hi], as sorted
  disjoint intervals."""
  out = []
  for start, end in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
    if end <= start:
      continue
    if out and start <= out[-1][1]:
      out[-1][1] = max(out[-1][1], end)
    else:
      out.append([start, end])
  return out


def covered(intervals, lo, hi) -> float:
  return sum(end - start for start, end in merged(intervals, lo, hi))


def gaps(intervals, lo, hi):
  """The parts of [lo, hi] that no interval covers."""
  out, cursor = [], lo
  for start, end in merged(intervals, lo, hi):
    if start > cursor:
      out.append((cursor, start))
    cursor = end
  if hi > cursor:
    out.append((cursor, hi))
  return out


# ---------------------------------------------------------------------------
# Module attributes replaced for one run.
# ---------------------------------------------------------------------------
class Patches:
  """Every module or class attribute that a run replaces (spans, the
  decode-step trace, a mode's recorder, a planted fault or control),
  on one stack, restored in reverse order by undo()."""

  def __init__(self):
    self._stack = []

  def patch(self, owner, name: str, value) -> None:
    own = vars(owner)
    self._stack.append((owner, name, name in own, own.get(name)))
    setattr(owner, name, value)

  def undo(self) -> None:
    while self._stack:
      owner, name, had, original = self._stack.pop()
      if had:
        setattr(owner, name, original)
      else:
        delattr(owner, name)


# ---------------------------------------------------------------------------
# Spans around the program's module attributes (traced runs only).
# ---------------------------------------------------------------------------
class Spans:
  """Wraps module attributes that the program calls through (on the
  run's Patches) and records a span per call; close() reads the CUDA
  events once the run's patches are undone.

  how: 'host' (host clock), 'sync' (host clock, ending in a device
  synchronise) or 'events' (CUDA events, read after the run).
  """

  def __init__(self, torch, patches: Patches):
    self.torch = torch
    self.patches = patches
    self.records: Dict[str, List[dict]] = {}
    self.unit = -1            # set-up's calls; the window's units count 0, 1, ...
    self.clean_before = None  # the first unit that ran under the profiler

  @contextlib.contextmanager
  def timed(self, name: str, unit: int):
    """A host span recorded by the harness itself."""
    t0 = time.perf_counter()
    with self.torch.profiler.record_function(name):
      yield
    self.records.setdefault(name, []).append(
        {'unit': unit, 'host_s': time.perf_counter() - t0})

  def wrap(self, target: str, how: str, name: Optional[str] = None):
    """Wrap `target`, a dotted path to a module attribute or to an
    attribute of a class in a module."""
    parts = target.split('.')
    for cut in range(len(parts) - 1, 0, -1):
      try:
        module = importlib.import_module('.'.join(parts[:cut]))
        break
      except ImportError:
        continue
    for part in parts[cut:-1]:
      module = getattr(module, part)
    attr = parts[-1]
    original = getattr(module, attr)
    name = name or target
    torch = self.torch
    records = self.records.setdefault(name, [])

    def wrapped(*args, **kwargs):
      record = {'unit': self.unit}
      if how == 'events':
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
      t0 = time.perf_counter()
      with torch.profiler.record_function(name):
        out = original(*args, **kwargs)
      if how == 'sync':
        torch.cuda.synchronize()
      record['host_s'] = time.perf_counter() - t0
      if how == 'events':
        end.record()
        record['events'] = (start, end)
      records.append(record)
      return out

    self.patches.patch(module, attr, wrapped)

  def close(self):
    for records in self.records.values():
      for record in records:
        if 'events' in record:
          start, end = record.pop('events')
          end.synchronize()
          record['device_s'] = start.elapsed_time(end) / 1e3

  def clean(self, unit: int) -> bool:
    """Whether `unit` of the window ran before the profiler (which slows
    the host for the rest of the process once it has run)."""
    return unit >= 0 and (self.clean_before is None
                          or unit < self.clean_before)

  def values(self, name: str, key: str):
    """`key` of each call of `name` in the window's units that ran before
    the profiler."""
    return [r[key] for r in self.records.get(name, [])
            if key in r and self.clean(r['unit'])]


# ---------------------------------------------------------------------------
# Profiler sessions.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Session:
  """One profiled stretch: device operations, launch calls, host ops, and
  the window (the stretch's own annotation) in seconds on one clock."""
  ops: List[tuple]          # (name, start_s, end_s, category)
  launches: int
  host: List[tuple]         # (name, start_s, end_s)
  lo: float
  hi: float

  @property
  def window_s(self) -> float:
    return self.hi - self.lo

  def kernels(self, match: Callable[[str], bool] = lambda name: True):
    return [op for op in self.ops if op[3] == 'kernel' and match(op[0])]

  def device_s(self, match: Callable[[str], bool]) -> float:
    return sum(min(e, self.hi) - max(s, self.lo)
               for _, s, e, _ in self.kernels(match)
               if min(e, self.hi) > max(s, self.lo))

  @property
  def busy_s(self) -> float:
    return covered([(s, e) for _, s, e, _ in self.ops], self.lo, self.hi)

  def idle_gaps(self):
    """[(what the host was doing, seconds)] of every device idle gap."""
    out = []
    for start, end in gaps([(s, e) for _, s, e, _ in self.ops], self.lo,
                           self.hi):
      mid = 0.5 * (start + end)
      around = [h for h in self.host if h[1] <= mid <= h[2]]
      label = (min(around, key=lambda h: h[2] - h[1])[0] if around
               else 'no host op')
      out.append((label, end - start))
    return out


WINDOW_MARK = 'gpubench.traced_window'
SYNC = 'cudaDeviceSynchronize'


def parse_chrome_trace(path: str) -> Session:
  """A session from a chrome trace.  Its window runs from the end of the
  first device synchronise to the end of the last (both the tracer's
  own), or, in a trace without them (a CPU run), over the tracer's
  WINDOW_MARK range."""
  with open(path) as f:
    events = json.load(f)['traceEvents']
  ops, host, syncs, launches, mark = [], [], [], 0, None
  for e in events:
    if e.get('ph') != 'X':
      continue
    cat, name = e.get('cat', ''), e.get('name', '')
    start = float(e['ts']) / 1e6
    end = start + float(e.get('dur', 0.0)) / 1e6
    if cat in DEVICE_OPS:
      ops.append((name, start, end, cat))
    elif cat in ('cuda_runtime', 'cuda_driver'):
      launches += any(m in name for m in LAUNCH_MARKS)
      if name == SYNC:
        syncs.append(end)
    elif cat in ('cpu_op', 'user_annotation'):
      if name == WINDOW_MARK:
        mark = (start, end)
      else:
        host.append((name, start, end))
  if len(syncs) >= 2:
    lo, hi = min(syncs), max(syncs)
  elif mark is not None:
    lo, hi = mark
  else:
    raise RuntimeError(f'no window in the trace {path}')
  return Session(ops=ops, launches=launches, host=host, lo=lo, hi=hi)


class Tracer:
  """torch.profiler sessions, each read from its chrome trace (written
  to TMPDIR and deleted) into a Session.

  A session records the device's operations and the host's CUDA runtime
  calls; with host=True also the host's operator calls, which label the
  idle gaps but slow the host's dispatch, so that the device idles
  longer: the metrics of idle time and launches read sessions without
  them.
  """

  def __init__(self, torch, cuda: bool = True):
    self.torch = torch
    self.cuda = cuda
    self.sessions: Dict[str, Session] = {}
    self._open = None

  def _sync(self):
    if self.cuda:
      self.torch.cuda.synchronize()

  def start(self, name: str, host: bool = False):
    torch = self.torch
    from torch.profiler import ProfilerActivity, profile
    self._sync()
    activities = ([ProfilerActivity.CUDA] if self.cuda
                  else [ProfilerActivity.CPU])
    if host and self.cuda:
      activities.append(ProfilerActivity.CPU)
    prof = profile(activities=activities)
    prof.__enter__()
    mark = torch.profiler.record_function(WINDOW_MARK)
    mark.__enter__()
    self._sync()
    self._open = (name, prof, mark)

  @property
  def open_name(self) -> Optional[str]:
    return self._open[0] if self._open else None

  def stop(self):
    name, prof, mark = self._open
    self._open = None
    self._sync()
    mark.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    import tempfile
    fd, path = tempfile.mkstemp(suffix='.json', prefix='gpubench_trace_')
    os.close(fd)
    try:
      prof.export_chrome_trace(path)
      self.sessions[name] = parse_chrome_trace(path)
    finally:
      os.remove(path)

  @property
  def active(self) -> bool:
    return self._open is not None

  @contextlib.contextmanager
  def session(self, name: str, host: bool = False):
    self.start(name, host)
    try:
      yield
    finally:
      self.stop()


def breakdown(op_sessions: List[Session], gap_sessions: List[Session],
              top: int = 10) -> dict:
  """The device operations that took most time (over `op_sessions`), and
  the longest idle gaps by what the host was doing (over `gap_sessions`,
  which record the host's operator calls)."""
  by_name: Dict[str, float] = {}
  for session in op_sessions:
    for name, start, end, _ in session.ops:
      by_name[name] = by_name.get(name, 0.0) + (end - start)
  idle = [gap for session in gap_sessions for gap in session.idle_gaps()]
  device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
  idle = sorted(idle, key=lambda g: -g[1])[:top]
  return {'device_ops': [[name[:200], s] for name, s in device_ops],
          'idle_gaps': [[name[:200], s] for name, s in idle]}


# ---------------------------------------------------------------------------
# What a traced run hands the per-layer readers.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Readings:
  sessions: Dict[str, Session]
  spans: Optional[Spans]
  counters: Dict[str, object]
  config: dict
  traffic: dict


@dataclasses.dataclass
class Check:
  """One number compared with its limit: correct while value <= limit."""
  name: str
  value: float
  limit: float

  @property
  def ok(self) -> bool:
    return self.value <= self.limit


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown_=None) -> str:
  out = {'correct': bool(correct), 'attempted': int(attempted),
         'failed': int(failed), 'metrics': metrics, 'device': device}
  if breakdown_ is not None:
    out['breakdown'] = breakdown_
  out['checks'] = {c.name: {'value': c.value, 'limit': c.limit}
                   for c in checks}
  return json.dumps(out)
