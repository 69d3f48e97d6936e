"""One run of a cell: set-up, window, comparison, result line.

A mode (gpubench/modes/<kind>.py) provides:
  setup(ctx) -> state            everything before the window
  unit(state, i) -> result       one unit of work, complete on return
  end_to_end(results, elapsed) -> {metric name: value}
  check(state, results) -> (checks, attempted, failed)
                                 frees the program's state, then compares
                                 what the window produced with the
                                 reference (the run's patches are undone
                                 by then)
  MAIN_SESSION                   the profiler session whose device busy
                                 time and window go into `device`
"""

from __future__ import annotations

import time

import torch

from gpubench import harness


class Context:
  """What a mode gets: the cell, the seed, the device, and in a traced
  run the spans and the profiler."""

  def __init__(self, cell, seed, seconds, trace, device, marks=None):
    self.cell, self.seed, self.seconds = cell, seed, seconds
    self.config, self.traffic = cell.config, cell.traffic
    self.device = device
    self.trace = trace
    self.patches = harness.Patches()
    self.spans = harness.Spans(torch, self.patches) if trace else None
    self.tracer = harness.Tracer(torch, self.cuda) if trace else None
    self.counters = {}
    self.limits = cell.limits
    self.unit = -1        # the window's unit that runs now (-1: set-up)
    self.trace_unit = None  # the unit that runs under the profiler
    self.marks = list(marks or [])

  def patch(self, owner, name: str, value) -> None:
    """Replaces owner.name by value until the window has closed."""
    self.patches.patch(owner, name, value)

  def mark(self, phase: str):
    """The end of a set-up phase (its time goes to standard error)."""
    self.sync()
    self.marks.append((phase, time.perf_counter()))

  @property
  def cuda(self) -> bool:
    return self.device.type == 'cuda'

  def sync(self):
    if self.cuda:
      torch.cuda.synchronize(self.device)


def _wrap_spans(ctx, readers):
  wanted = {}
  for reader in readers.values():
    wanted.update(getattr(reader, 'WRAP', {}))
  for target, how in sorted(wanted.items()):
    ctx.spans.wrap(target, how if ctx.cuda else 'host')


def run(cell, seed: int, seconds: float, trace: bool, device, start: float,
        out=print, marks=None, plant=None) -> int:
  """One run of `cell`; prints its result line through `out`.  `plant`
  (gpubench/faults.py; never in a benchmark run) puts a fault or the
  control underneath the timed path before set-up."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.set_num_threads(4)
  ctx = Context(cell, seed, seconds, trace, device, marks)
  mode = cell.mode()
  readers = ({m['name']: cell.reader(m['name']) for m in cell.per_layer}
             if trace else {})
  window_start, ends = [], []

  def unit(i):
    """Unit i; in a traced run the first unit that starts in the window's
    second half runs under the profiler, after the units that the span
    metrics read."""
    now = time.perf_counter()
    window_start[:] = window_start or [now]
    if trace and ctx.trace_unit is None and now - window_start[0] >= (
        seconds / 2):
      ctx.trace_unit = ctx.spans.clean_before = i
    ctx.unit = i
    if ctx.spans is not None:
      ctx.spans.unit = i
    out = mode.unit(state, i)
    ends.append(time.perf_counter())
    return out

  try:
    if trace:
      _wrap_spans(ctx, readers)
    if plant is not None:
      plant(ctx)
    state = mode.setup(ctx)
    ctx.sync()
    if ctx.cuda:
      torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - start
    elapsed, results = harness.window(unit, seconds)
    if trace and ctx.trace_unit is None:
      # Every unit started in the first half: one more, traced, after the
      # window (a traced run reports no end-to-end metric).
      ctx.trace_unit = ctx.spans.clean_before = len(results)
      unit(len(results))
    peak = torch.cuda.max_memory_allocated(device) if ctx.cuda else 0
    if ctx.tracer is not None and ctx.tracer.active:
      ctx.tracer.stop()
  finally:
    ctx.patches.undo()
  if ctx.spans is not None:
    ctx.spans.close()
  harness.log(f'gpubench: {cell.name} seed {seed}: set-up {setup_s:.3f} s, '
              f'window {elapsed:.3f} s, {len(results)} units')
  if window_start:
    marks = window_start + ends[:len(results)]
    harness.log('unit seconds: ' + ', '.join(
        f'{b - a:.3f}' for a, b in zip(marks, marks[1:])))
  phases, last = [], start
  for phase, at in ctx.marks:
    phases.append(f'{phase} {at - last:.3f}')
    last = at
  harness.log('set-up phases (s): ' + ', '.join(phases))

  check_start = time.perf_counter()
  checks, attempted, failed = mode.check(state, results)
  del state
  harness.log(f'comparison with the reference: '
              f'{time.perf_counter() - check_start:.3f} s')

  if trace:
    readings = harness.Readings(ctx.tracer.sessions, ctx.spans, ctx.counters,
                                cell.config, cell.traffic)
    metrics = {}
    for m in cell.per_layer:
      if m['source'] == 'device_trace' and not ctx.cuda:
        continue   # no device number from a CPU run
      value = readers[m['name']].read(readings)
      if value is not None:
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
  else:
    values = dict(mode.end_to_end(results, elapsed), setup_s=setup_s,
                  peak_mem_gib=peak / harness.GIB)
    metrics = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
               for m in cell.end_to_end}

  device_info = {'platform': 'gpu' if ctx.cuda else 'cpu',
                 'kind': (torch.cuda.get_device_name(device) if ctx.cuda
                          else 'cpu'),
                 'count': 1, 'memory_peak_bytes': int(peak)}
  breakdown = None
  if trace:
    main = ctx.tracer.sessions.get(mode.MAIN_SESSION)
    if main is not None:
      device_info.update(busy_s=main.busy_s, window_s=main.window_s)
    sessions = ctx.tracer.sessions
    breakdown = harness.breakdown(
        [s for n, s in sessions.items() if not n.endswith('_host')],
        [s for n, s in sessions.items() if n.endswith('_host')])

  loaded = harness.forbidden_modules()
  if loaded:
    harness.log(f'gpubench: the run loaded {loaded}; no result')
    return 5
  correct = all(c.ok for c in checks)
  for c in checks:
    harness.log(f'check {c.name}: {c.value!r} (limit {c.limit!r}) '
                f'{"ok" if c.ok else "FAILED"}')
  out(harness.result_line(correct, attempted, failed, metrics, device_info,
                          checks, breakdown))
  return 0
