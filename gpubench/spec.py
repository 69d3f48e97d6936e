"""Finds everything of a cell by the names in BENCHMARK.json.

  BENCHMARK.json                      the cells, configurations and metrics
  gpubench/configs/<config>.json      a configuration (its `file` entry)
  gpubench/traffic/<traffic>.json     a traffic mix; its `kind` names the
                                      driver, gpubench/modes/<kind>.py
  gpubench/families/<family>.py       the model family of a configuration
                                      file that states `family` (none:
                                      MT3's T5, gpubench/program.py)
  gpubench/metrics/<metric>.py        the reader of a per-layer metric
  gpubench/limits/<cell>.json         the limit of each number the cell's
                                      comparison checks

A new cell is an entry in BENCHMARK.json and, at most, new files.
"""

from __future__ import annotations

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
    self._modules = {}

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
    """The driver of the cell's traffic kind, gpubench/modes/<kind>.py
    under the cell's root: one module for the cell, so that a plant of
    gpubench/faults.py patches the one that the run uses."""
    if 'mode' not in self._modules:
      kind = self.traffic['kind']
      self._modules['mode'] = _load(
          self.root / 'gpubench' / 'modes' / f'{kind}.py',
          f'gpubench_mode_{kind}')
    return self._modules['mode']

  def family(self):
    """The configuration's family module, or None for MT3's T5."""
    name = self.config.get('family')
    if name is not None and 'family' not in self._modules:
      self._modules['family'] = load_family(self.root, name)
    return self._modules.get('family')


def _load(path: pathlib.Path, name: str):
  spec = importlib.util.spec_from_file_location(
      name.replace('.', '_'), path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def load_reader(folder: pathlib.Path, metric_name: str):
  return _load(folder / f'{metric_name}.py', f'gpubench_metric_{metric_name}')


def load_family(root: pathlib.Path, name: str):
  """gpubench/families/<name>.py under `root`: `check(cfg)` raises where a
  configuration file and the port disagree on a number the file states;
  the rest (weights, reference, token ids) is for the family's modes."""
  return _load(root / 'gpubench' / 'families' / f'{name}.py',
               f'gpubench_family_{name}')


def same_as(metric_name: str):
  """(WRAP, read) of the reader gpubench/metrics/<metric_name>.py beside
  this file: for a metric that reads the same quantity in other cells,
  where it moves another end-to-end metric."""
  module = load_reader(HERE / 'metrics', metric_name)
  return getattr(module, 'WRAP', {}), module.read
