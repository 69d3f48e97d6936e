"""The system under test, as the benchmark sees it: mt3_tpu_torch.

The configuration file holds the model as it is run; the port's preset
named in it supplies the rest (codec, spectrogram, lengths) and must
agree with every number the file states.
"""

from __future__ import annotations

import dataclasses

from mt3_tpu_torch.core import config as config_lib


def _check(what, file_values, port_object):
  for key, want in file_values.items():
    got = getattr(port_object, key)
    if isinstance(got, tuple):
      got = list(got)
    if got != want:
      raise SystemExit(f'{what}.{key}: the configuration file states '
                       f'{want!r}, the port runs {got!r}')


def config(cfg: dict, **model_overrides) -> config_lib.MT3Config:
  """The port's MT3Config for a configuration file: the preset, with the
  file's model numbers, lengths and activation dtype, checked against it."""
  preset = config_lib.CONFIG_FACTORIES[cfg['preset']]()
  model = dataclasses.replace(
      preset.model, dtype=cfg['dtype'],
      **{k: tuple(v) if isinstance(v, list) else v
         for k, v in cfg['model'].items()}, **model_overrides)
  run = dataclasses.replace(preset.run, **{
      k: cfg['run'][k] for k in ('inputs_length', 'targets_length')})
  out = dataclasses.replace(preset, model=model, run=run)
  _check('spectrogram', cfg['spectrogram'], out.spectrogram)
  _check('vocab', {k: v for k, v in cfg['vocab'].items()
                   if k in ('steps_per_second', 'max_shift_seconds',
                            'num_velocity_bins')}, out.vocab)
  _check('run', cfg['run'], out.run)
  _check('run', {'use_ties': cfg['vocab']['use_ties']}, out.run)
  from mt3_tpu_torch.codec import vocabulary
  vocab = vocabulary.vocabulary_from_codec(vocabulary.build_codec(out.vocab))
  if vocabulary.num_embeddings(vocab) != model.vocab_size:
    raise SystemExit(f'vocab_size {model.vocab_size} is not the codec\'s '
                     f'{vocabulary.num_embeddings(vocab)}')
  return out


def load_kernels(ctx, names) -> None:
  """Builds (once per checkout, into build/kernels/) and loads the port's
  kernel libraries `names`, as their first call would; a set-up phase."""
  if ctx.cuda:
    from mt3_tpu_torch.ops import cuda_build
    cuda_build.build(names)
    for name in names:
      cuda_build.library(name)
    if cuda_build.BUILD_LOGS:
      from gpubench import harness
      harness.log('nvcc built ' + ', '.join(
          f'{n} ({s:.1f} s)' for n, (s, _) in cuda_build.BUILD_LOGS.items()))
  ctx.mark('kernel build and load')
