"""A stand-in model family for CPU tests, copied into a throwaway root as
gpubench/families/tiny_other.py: the port's T5 under token ids of its own
(an end id that is not MT3's EOS, and no id that is never served), fed
seeded features in place of a front end.  It shows that a configuration
of another family joins the benchmark from new files alone."""

from __future__ import annotations

import torch

from gpubench import weights
from gpubench.reference import model as ref_model


def model_config(cfg):
  """The port's model configuration as the file states it."""
  from mt3_tpu_torch.core import config as config_lib
  return config_lib.ModelConfig(dtype=cfg['dtype'], **{
      k: tuple(v) if isinstance(v, list) else v
      for k, v in cfg['model'].items()})


def check(cfg) -> None:
  """Raises where the file and the port disagree on a number it states."""
  port = model_config(cfg)
  for key, want in cfg['model'].items():
    got = getattr(port, key)
    if (list(got) if isinstance(got, tuple) else got) != want:
      raise ValueError(f'model.{key}: the file states {want!r}, the port '
                       f'runs {got!r}')
  for token in [cfg['end_id'], *cfg['never_served']]:
    if not 0 <= token < port.vocab_size:
      raise ValueError(f'token id {token} outside the vocabulary of '
                       f'{port.vocab_size}')


def ids(cfg) -> dict:
  """The id arguments of gpubench/serving.py's checks."""
  return dict(end_id=cfg['end_id'], never=tuple(cfg['never_served']))


def make_weights(cfg, seed: int, device) -> dict:
  return weights.make(cfg['model'], seed, device)


def reference_logits(params, cfg, features, tokens, prec='float32'):
  """Teacher-forced logits [r, T, V] of the plain reference over rows of
  features [r, frames, depth] and their served tokens [r, T]."""
  with torch.no_grad():
    encoded = ref_model.encode(params, cfg['model'], features, prec)
    return ref_model.decode(params, cfg['model'], encoded,
                            ref_model.shift_right(tokens), prec)
