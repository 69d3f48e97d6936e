"""mt3_tpu_torch: the PyTorch / CUDA port of mt3_tpu for NVIDIA Hopper GPUs.

A second package beside the JAX one, with the same module layout and
function names.  It imports torch, numpy and scipy, never jax nor
mt3_tpu: the host-side modules it needs are kept as its own copies.

Layers (bottom-up):
  core      -- configs, NoteSequence data model, MIDI I/O
  codec     -- event codec, token vocabulary, run-length encoding,
               note-event state machines (host-side)
  ops       -- log-mel frontend and the hand-written CUDA kernels (csrc/):
               log-mel, decode attention, flash attention for training
  models    -- T5-style encoder-decoder as functions over a parameter tree
  infer     -- KV-cached decode, sliding-window transcription
  data      -- training data pipeline, synthetic source, WAV reading
  train     -- losses, Adafactor, train step and Trainer, checkpoints
  cli       -- transcribe and train entry points

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
  checkpoint_dir: reading checkpoints is not ported yet, so any value
  raises NotImplementedError.  params (keyword only): a parameter tree
  (params.from_numpy_tree / params.init_params); None draws random weights
  from torch.Generator seed 0.
  """
  import dataclasses

  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.device import resolve_device
  from mt3_tpu_torch.infer.transcribe import Transcriber

  device = resolve_device(device)
  if checkpoint_dir:
    raise NotImplementedError(params_lib.CHECKPOINTS_NOT_PORTED)
  config = config_lib.CONFIG_FACTORIES[model]()
  if bfloat16:
    config = dataclasses.replace(
        config, model=dataclasses.replace(config.model, dtype='bfloat16'))
  if params is None:
    params = params_lib.init_params(config.model, device=device)
  return Transcriber(config, params, device=device, **kwargs)
