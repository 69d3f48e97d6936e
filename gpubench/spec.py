"""Finds everything of a cell by the names in BENCHMARK.json.

  BENCHMARK.json                      the cells, configurations and metrics
  gpubench/configs/<config>.json      a configuration (its `file` entry)
  gpubench/traffic/<traffic>.json     a traffic mix; its `kind` names the
                                      driver, gpubench/modes/<kind>.py
  gpubench/metrics/<metric>.py        the reader of a per-layer metric
  gpubench/limits/<cell>.json         the limit of each number the cell's
                                      comparison checks

A new cell is an entry in BENCHMARK.json and, at most, new files.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


class Cell:
  """One workload of BENCHMARK.json with its configuration and traffic."""

  def __init__(self, name: str, root: pathlib.Path = HERE.parent):
    self.root = root
    self.spec = json.loads((root / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in self.spec['workloads']}
    if name not in cells:
      raise SystemExit(f'no workload {name!r} in BENCHMARK.json; '
                       f'known: {sorted(cells)}')
    self.workload = cells[name]
    self.name = name
    configs = {c['name']: c for c in self.spec['configs']}
    self.config_entry = configs[self.workload['config']]
    self.config = json.loads((root / self.config_entry['file']).read_text())
    self.traffic_name = self.workload['traffic']
    self.traffic = json.loads(
        (root / 'gpubench' / 'traffic' / f'{self.traffic_name}.json')
        .read_text())
    self.chips = self.workload['chips']
    limits = root / 'gpubench' / 'limits' / f'{name}.json'
    self.limits = json.loads(limits.read_text()) if limits.exists() else {}

  def _applies(self, metric):
    return 'workloads' not in metric or self.name in metric['workloads']

  @property
  def end_to_end(self):
    return [m for m in self.spec['end_to_end'] if self._applies(m)]

  @property
  def per_layer(self):
    return [m for m in self.spec['per_layer'] if self._applies(m)]

  def reader(self, metric_name: str):
    """The module gpubench/metrics/<metric_name>.py (names may hold dots)."""
    return load_reader(self.root / 'gpubench' / 'metrics', metric_name)

  def mode(self):
    return importlib.import_module(f'gpubench.modes.{self.traffic["kind"]}')


def load_reader(folder: pathlib.Path, metric_name: str):
  path = folder / f'{metric_name}.py'
  spec = importlib.util.spec_from_file_location(
      f'gpubench_metric_{metric_name.replace(".", "_")}', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def same_as(metric_name: str):
  """(WRAP, read) of the reader gpubench/metrics/<metric_name>.py beside
  this file: for a metric that reads the same quantity in other cells,
  where it moves another end-to-end metric."""
  module = load_reader(HERE / 'metrics', metric_name)
  return getattr(module, 'WRAP', {}), module.read
