"""The contract of a configuration file: what it states against what the
port runs, checked by the file's own model family, and how a cut from the
published configuration is written down (model-configs section 4)."""

from __future__ import annotations

import json
import pathlib
import re

from gpubench import spec

TEXT = re.compile(r'[^\n\t]{1,200}')
# A cut in depth: a count of layers.
DEPTH = re.compile(r'num_\w*layers')
# A width, which is never cut, not even as the chip's share.
WIDTH = re.compile(r'.*(_dim|_rank|d_model|width|hidden|intermediate|latent'
                   r'|state|proj|head_size|expansion|per_tok).*')


def _stated(cfg: dict, key: str):
  """The file's value of `key`: under `model`, else at the top level."""
  return cfg.get('model', {}).get(key, cfg.get(key))


def check_cut(cfg: dict, key: str) -> None:
  """A key of `reduced` is a depth (a count of layers) or the chip's share
  of a stated deployment (the file's `chip_share`: {key: chips that share
  a layer}), never a width, and the file's value lies below the published
  one: for a share, what one of those chips holds of it."""
  chips = cfg.get('chip_share', {}).get(key)
  if not DEPTH.fullmatch(key):
    assert not WIDTH.fullmatch(key), f'{key!r} is a width, never cut'
    assert chips is not None, (
        f'{key!r} is neither a depth nor a declared chip share')
  value, published = _stated(cfg, key), cfg['published'][key]
  assert isinstance(value, int) and 0 < value < published, (
      f'{key}: the file holds {value!r}, published {published!r}')
  if chips is not None:
    assert value * chips >= published, (
        f'{key}: {chips} chips of {value} hold less than {published}')


def check_config(root: pathlib.Path, entry: dict) -> None:
  """Raises AssertionError where the configuration file of `entry` (one of
  BENCHMARK.json's `configs`, under `root`) breaks the contract.

  A file with no `family` is MT3's T5: it states no cut and no assumed
  size, and gpubench/program.py builds the port's configuration from it.
  A file with a family is held to its family's `check`.  Every file lists
  each key of the entry's `reduced` in its own `reduced`, with the
  published value under `published` and a cut that check_cut allows, and
  each `assumed` entry is one line of text."""
  cfg = json.loads((root / entry['file']).read_text())
  if 'family' not in cfg:
    from gpubench import program
    assert cfg['reduced'] == [] and cfg['assumed'] == []
    port = program.config(cfg)
    for key, value in cfg['model'].items():
      got = getattr(port.model, key)
      assert (list(got) if isinstance(got, tuple) else got) == value
  else:
    family = spec.load_family(root, cfg['family'])
    try:
      family.check(cfg)
    except (Exception, SystemExit) as e:
      raise AssertionError(f'{entry["name"]}: family {cfg["family"]!r} '
                           f'refuses the file: {e}') from e
  assert sorted(cfg['reduced']) == sorted(entry['reduced']), (
      f'{entry["name"]}: BENCHMARK.json reduces {entry["reduced"]}, the '
      f'file {cfg["reduced"]}')
  published = cfg.get('published', {})
  for key in cfg['reduced']:
    assert key in published, f'{entry["name"]}: no published {key!r}'
    check_cut(cfg, key)
  assert isinstance(cfg['assumed'], list)
  for text in cfg['assumed']:
    assert isinstance(text, str) and TEXT.fullmatch(text), repr(text)
