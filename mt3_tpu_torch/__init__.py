"""mt3_tpu_torch: the PyTorch / CUDA port of mt3_tpu for NVIDIA Hopper GPUs.

A second package beside the JAX one, with the same module layout and
function names.  It imports torch, numpy and scipy, never jax nor
mt3_tpu: the host-side modules it needs are kept as its own copies.  Two
optional packages are imported where one call needs them and nowhere
else: tensorstore to read orbax checkpoints (and blosc-compressed T5X
arrays), PIL to write a pianoroll PNG.

Layers (bottom-up):
  core      -- configs, NoteSequence data model, MIDI I/O, the
               NoteSequence proto wire format
  codec     -- event codec, token vocabulary, run-length encoding,
               note-event state machines (host-side)
  ops       -- log-mel frontend and the hand-written CUDA kernels (csrc/):
               log-mel, decode attention, flash attention for training
  models    -- T5-style encoder-decoder as functions over a parameter tree
  infer     -- KV-cached greedy decode, beam search, sliding-window
               transcription (on one device or a mesh), JSON-lines output
  data      -- data sources (synthetic, polyphonic synth, wav+MIDI
               directories, MAESTRO, reference-schema TFRecords, mixtures),
               TFRecord IO (the native reader built at first use), the
               training pipeline and its offline segment cache
  parallel  -- the ('data', 'model') mesh on torch.distributed, one
               process per device: logical-axis rules, parameter shards,
               the model-parallel collectives, multi-process setup
  train     -- losses, Adafactor, train step and Trainer, checkpoints
               (the port's own, written at once or on a thread; the JAX
               package's orbax ones; T5X), on one device or a mesh
  eval      -- transcription metrics, the evaluation driver, summaries
  utils     -- TensorBoard event files, torch.profiler tracing, timers
  cli       -- transcribe, train and evaluate entry points
  scripts   -- dump_task, extract_monophonic_examples

Entry points run on CUDA unless the caller passes device='cpu'.
"""

__version__ = '0.1.0'


def load_transcriber(model: str = 'mt3', checkpoint_dir=None,
                     bfloat16: bool = True, *, params=None, device=None,
                     **kwargs):
  """Config preset + params -> Transcriber on `device` (CUDA by default).

      import mt3_tpu_torch
      ns = mt3_tpu_torch.load_transcriber('mt3')(audio)

  The first three parameters are mt3_tpu.load_transcriber's, in its order.
  checkpoint_dir: a directory of checkpoints (the latest step is read) or
  one checkpoint: the port's checkpoint_<step>.pt or the JAX package's
  orbax checkpoint_<step>/ (train/checkpoint.restore_params).  params
  (keyword only): a parameter tree (params.from_numpy_tree /
  params.init_params), in place of a checkpoint.  With neither, the
  weights are random (torch.Generator seed 0).
  """
  import dataclasses

  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.device import resolve_device
  from mt3_tpu_torch.infer.transcribe import Transcriber
  from mt3_tpu_torch.train import checkpoint as ckpt_lib

  device = resolve_device(device)
  if checkpoint_dir and params is not None:
    raise ValueError('pass checkpoint_dir or params, not both')
  config = config_lib.CONFIG_FACTORIES[model]()
  if bfloat16:
    config = dataclasses.replace(
        config, model=dataclasses.replace(config.model, dtype='bfloat16'))
  if checkpoint_dir:
    params, _ = ckpt_lib.load_params(checkpoint_dir, config.model)
  elif params is None:
    params = params_lib.init_params(config.model, device=device)
  return Transcriber(config, params, device=device, **kwargs)
