"""The program's own spans and counters (mt3_tpu_torch.utils.profiling),
as the per-layer readers see them.

A reader that reads them calls start() when it is loaded.
gpubench/driver.py loads the readers in a traced run only, before
set-up, so the program records its spans in the traced runs and in no
run that measures the end-to-end metrics.  A program without the recorder (an older checkout)
records nothing; every reading here is then None.

Host times are kept only from spans that closed before any profiler ran
(`after_profiler` false): the profiler slows the host for the rest of the
process.  A decode reading is a ratio of sums over the clean calls, as
decode_step_ms's is (set-up calls no decode_tokens); the others are
medians over calls, so that set-up's cold first call does not count.
"""

from __future__ import annotations

import statistics

NAMES = ('enable', 'enabled', 'reset', 'collect')


def _recorder():
  try:
    from mt3_tpu_torch.utils import profiling
  except ImportError:
    return None
  return profiling if all(hasattr(profiling, n) for n in NAMES) else None


def start() -> None:
  """Empties the program's recorder and turns it on."""
  profiling = _recorder()
  if profiling is not None:
    profiling.reset()
    profiling.enable()


def collected():
  """What the program recorded, or None."""
  profiling = _recorder()
  if profiling is None or not profiling.enabled():
    return None
  return profiling.collect()


def _clean(spans, name):
  return [s for s in spans if s['name'] == name and not s['after_profiler']]


def _ms(s):
  return (s['end_ns'] - s['start_ns']) / 1e6


def per_decode_step(name):
  """Host milliseconds per decode step spent in spans `name` that are
  children of the clean decode_tokens calls (spans 'decode'), over those
  calls' steps: summed over the same calls as decode_step_ms, so that the
  children's shares add up to it."""
  got = collected()
  if got is None:
    return None
  calls = {s['id'] for s in _clean(got['spans'], 'decode')}
  spent, steps = 0.0, 0
  for s in got['spans']:
    if s['parent'] in calls:
      steps += s['name'] == 'decode.step'
      if s['name'] == name:
        spent += _ms(s)
  return spent / steps if steps else None


def host_ms(name):
  """Median host milliseconds of the clean spans `name`."""
  got = collected()
  if got is None:
    return None
  times = [_ms(s) for s in _clean(got['spans'], name)]
  return statistics.median(times) if times else None


def device_ms_per_train_step(name):
  """Median over the clean train steps (spans 'train.step') of the device
  milliseconds of the step's spans `name` (CUDA events), summed over the
  step; None where the spans hold no device time (a CPU run)."""
  got = collected()
  if got is None:
    return None
  steps = {s['id'] for s in _clean(got['spans'], 'train.step')}
  spent = {}
  for s in got['spans']:
    if s['root'] in steps and s['name'] == name:
      if s['device_ms'] is None:
        return None
      spent[s['root']] = spent.get(s['root'], 0.0) + s['device_ms']
  return statistics.median(spent.values()) if spent else None


def counter(name):
  got = collected()
  return None if got is None else got['counters'].get(name)
