"""Typed configuration dataclasses (copy of mt3_tpu/core/config.py).

The reference spreads configuration over gin files
(mt3/gin/*.gin) plus dataclasses in spectrograms.py and
vocabularies.py.  Here the whole surface collapses into four dataclasses:
SpectrogramConfig, VocabularyConfig, ModelConfig, RunConfig, with the two
published model flavors ("ismir2021", "mt3") and a tiny CPU-smoke preset as
named factory functions.

The PyTorch port keeps its own copy so that it imports nothing of
mt3_tpu.  The field comments say what each option does; the measurements
behind the JAX package's defaults are in mt3_tpu/core/config.py and in
its PERF.md log (commit 20b6a21).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# MIDI constants (reference gets these from note_seq).
# ---------------------------------------------------------------------------
MIN_MIDI_PITCH = 0
MAX_MIDI_PITCH = 127
MIN_MIDI_PROGRAM = 0
MAX_MIDI_PROGRAM = 127
MAX_MIDI_VELOCITY = 127

# ---------------------------------------------------------------------------
# Spectrogram config.
# Reference: mt3/spectrograms.py:23-52
# ---------------------------------------------------------------------------
DEFAULT_SAMPLE_RATE = 16000
DEFAULT_HOP_WIDTH = 128
DEFAULT_NUM_MEL_BINS = 512

# Fixed constants, matching the reference (spectrograms.py:27-29).  The
# reference's compute_spectrogram leaves the mel upper edge at the
# compute_logmel default of 7600 Hz (spectral_ops.py:76-88).
FFT_SIZE = 2048
MEL_LO_HZ = 20.0
MEL_HI_HZ = 7600.0


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
  """Spectrogram configuration parameters."""
  sample_rate: int = DEFAULT_SAMPLE_RATE
  hop_width: int = DEFAULT_HOP_WIDTH
  num_mel_bins: int = DEFAULT_NUM_MEL_BINS

  @property
  def abbrev_str(self) -> str:
    s = ''
    if self.sample_rate != DEFAULT_SAMPLE_RATE:
      s += 'sr%d' % self.sample_rate
    if self.hop_width != DEFAULT_HOP_WIDTH:
      s += 'hw%d' % self.hop_width
    if self.num_mel_bins != DEFAULT_NUM_MEL_BINS:
      s += 'mb%d' % self.num_mel_bins
    return s

  @property
  def frames_per_second(self) -> float:
    return self.sample_rate / self.hop_width

  @property
  def fft_size(self) -> int:
    return FFT_SIZE

  @property
  def mel_lo_hz(self) -> float:
    return MEL_LO_HZ

  @property
  def mel_hi_hz(self) -> float:
    return MEL_HI_HZ

  @property
  def input_depth(self) -> int:
    return self.num_mel_bins


# ---------------------------------------------------------------------------
# Vocabulary config.
# Reference: mt3/vocabularies.py:30-54
# ---------------------------------------------------------------------------
DEFAULT_STEPS_PER_SECOND = 100
DEFAULT_MAX_SHIFT_SECONDS = 10
DEFAULT_NUM_VELOCITY_BINS = 127


@dataclasses.dataclass(frozen=True)
class VocabularyConfig:
  """Vocabulary configuration parameters."""
  steps_per_second: int = DEFAULT_STEPS_PER_SECOND
  max_shift_seconds: int = DEFAULT_MAX_SHIFT_SECONDS
  num_velocity_bins: int = DEFAULT_NUM_VELOCITY_BINS

  @property
  def abbrev_str(self) -> str:
    s = ''
    if self.steps_per_second != DEFAULT_STEPS_PER_SECOND:
      s += 'ss%d' % self.steps_per_second
    if self.max_shift_seconds != DEFAULT_MAX_SHIFT_SECONDS:
      s += 'ms%d' % self.max_shift_seconds
    if self.num_velocity_bins != DEFAULT_NUM_VELOCITY_BINS:
      s += 'vb%d' % self.num_velocity_bins
    return s


# ---------------------------------------------------------------------------
# Model config.
# Reference network dims: mt3/gin/model.gin:46-59 and
# network.py:25-41.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
  """T5-style encoder-decoder hyperparameters."""
  vocab_size: int
  emb_dim: int = 512
  num_heads: int = 6
  num_encoder_layers: int = 8
  num_decoder_layers: int = 8
  head_dim: int = 64
  mlp_dim: int = 1024
  mlp_activations: Sequence[str] = ('gelu', 'linear')
  dropout_rate: float = 0.1
  logits_via_embedding: bool = False
  # Depth of continuous encoder inputs (num mel bins).
  input_depth: int = DEFAULT_NUM_MEL_BINS
  # Activation dtype: 'float32' or 'bfloat16'.  Params are always float32.
  dtype: str = 'float32'
  # Maximum (fixed sinusoidal) position, reference layers.py:565.
  max_positions: int = 2048
  # KV-cache write strategy during decode: 'dus' (in-place column write)
  # or 'onehot' (broadcast-add, rewrites the cache every step).
  decode_cache_update: str = 'dus'
  # Training/teacher-forced attention implementation: 'xla' (einsum +
  # materialized [b,h,q,k] scores, exact reference numerics) or 'flash'
  # (stock TPU Pallas blockwise kernel — no score materialization).
  # Attention dropout composes with flash via a pre-kernel V rescale
  # that is exactly the reference's query-broadcast weight dropout
  # (layers.attention).
  train_attention_impl: str = 'xla'
  # Decode tokens between two all-done checks (amortizes the fixed
  # per-check cost).  decode_tokens clamps it to a divisor of the decode
  # length.
  decode_steps_per_iter: int = 16
  # Decoder self-attention implementation during decode: 'xla'
  # (production) or 'pallas_v3' (aliased in-place cache kernel).  In the
  # port both name the same CUDA kernel (models/layers.py).
  decode_attention_impl: str = 'xla'
  # How the decode KV cache is carried across layers inside a step:
  # 'stacked' writes each layer's new column into the full stacked
  # [L,b,h,d,len] cache with one small dynamic_update_slice (in-place on
  # the while-loop carry); 'scan' carries per-layer slices through
  # lax.scan ys, whose stacked outputs rebuild the cache every decode
  # step (a potential cache-sized copy per token).  pallas_v3 requires
  # 'scan'.
  decode_cache_carry: str = 'scan'
  # Rematerialize each transformer layer in the backward pass (trades
  # FLOPs for activation memory; enables large-batch training).
  remat: bool = False
  # Remat policy when remat=True: 'full' recomputes everything;
  # 'dots' saves matmul outputs and recomputes only cheap elementwise
  # ops (jax.checkpoint_policies.dots_with_no_batch_dims_saveable) —
  # much less recompute for a modest memory increase.
  remat_policy: str = 'full'
  # int8-quantize the decoder KV cache (per-(batch,head,position)
  # scales): halves decode cache read traffic at a small quantization
  # error on K/V.
  decode_kv_quantize: bool = False
  # Bits for the quantized self-attention cache: 8 (int8) or 4 (int4 —
  # halves cache read traffic again; larger quantization error, gate on
  # the F1-delta test before shipping).
  decode_kv_bits: int = 8
  # int8-quantize the cross-attention K/V (projected once per segment,
  # re-read every decode step, a fixed per-step memory cost that grows
  # with the batch).  Same per-(b,h,position) scale scheme.
  decode_cross_kv_quantize: bool = False
  # Grouped-query attention: number of K/V heads (None = num_heads,
  # standard multi-head).  Cuts decode KV-cache traffic by
  # num_heads/num_kv_heads; for from-scratch training only (published
  # checkpoints are MHA).
  num_kv_heads: Optional[int] = None

  @property
  def kv_heads(self) -> int:
    return self.num_kv_heads or self.num_heads


@dataclasses.dataclass(frozen=True)
class RunConfig:
  """Training / inference run parameters.

  Reference: gin/train.gin (LR schedule, batch, checkpoint period),
  gin/{mt3,ismir2021}.gin (lengths, steps), colab cell 2 (inference batch).
  """
  inputs_length: int = 256
  targets_length: int = 1024
  train_steps: int = 1000000
  batch_size: int = 256
  infer_batch_size: int = 8
  learning_rate: float = 1e-3
  warmup_steps: int = 1000
  z_loss: float = 1e-4
  label_smoothing: float = 0.0
  checkpoint_period: int = 5000
  eval_period: int = 5000
  onsets_only: bool = False
  use_ties: bool = True
  program_granularity: str = 'full'
  max_examples_per_mix: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class MT3Config:
  """Bundle of all configs describing one model flavor."""
  name: str
  spectrogram: SpectrogramConfig
  vocab: VocabularyConfig
  model: ModelConfig
  run: RunConfig


def _num_embeddings_for(vocab_config: VocabularyConfig) -> int:
  # Local import to avoid a cycle (vocabulary imports config constants).
  from mt3_tpu_torch.codec import vocabulary as vocab_lib
  codec = vocab_lib.build_codec(vocab_config)
  vocab = vocab_lib.vocabulary_from_codec(codec)
  return vocab_lib.num_embeddings(vocab)


def mt3_config() -> MT3Config:
  """Multi-task multitrack model ("mt3"), reference gin/mt3.gin."""
  spectrogram = SpectrogramConfig()
  vocab = VocabularyConfig(num_velocity_bins=1)
  model = ModelConfig(vocab_size=_num_embeddings_for(vocab),
                      input_depth=spectrogram.num_mel_bins)
  run = RunConfig(inputs_length=256, targets_length=1024,
                  train_steps=1000000, onsets_only=False, use_ties=True,
                  program_granularity='full')
  return MT3Config('mt3', spectrogram, vocab, model, run)


def ismir2021_config() -> MT3Config:
  """Piano-only model ("ismir2021"), reference gin/ismir2021.gin."""
  spectrogram = SpectrogramConfig()
  vocab = VocabularyConfig(num_velocity_bins=127)
  model = ModelConfig(vocab_size=_num_embeddings_for(vocab),
                      input_depth=spectrogram.num_mel_bins)
  run = RunConfig(inputs_length=512, targets_length=1024,
                  train_steps=400000, onsets_only=False, use_ties=False,
                  program_granularity='flat')
  return MT3Config('ismir2021', spectrogram, vocab, model, run)


def tiny_config(vocab: Optional[VocabularyConfig] = None) -> MT3Config:
  """Tiny CPU-smoke model, reference gin/local_tiny.gin."""
  spectrogram = SpectrogramConfig()
  vocab = vocab or VocabularyConfig(num_velocity_bins=1)
  model = ModelConfig(
      vocab_size=_num_embeddings_for(vocab),
      emb_dim=32, num_heads=4, num_encoder_layers=2, num_decoder_layers=2,
      head_dim=8, mlp_dim=32, mlp_activations=('gelu', 'linear'),
      dropout_rate=0.0, input_depth=spectrogram.num_mel_bins)
  run = RunConfig(inputs_length=8, targets_length=16, train_steps=3,
                  batch_size=8, use_ties=True)
  return MT3Config('tiny', spectrogram, vocab, model, run)


def mt3_pretrain_config() -> MT3Config:
  """MT3 pretraining recipe (reference gin/ismir2022/pretrain.gin)."""
  base = mt3_config()
  run = dataclasses.replace(
      base.run, train_steps=500000, batch_size=1024,
      label_smoothing=0.1, max_examples_per_mix=8)
  return dataclasses.replace(base, name='mt3_pretrain', run=run)


def mt3_finetune_config() -> MT3Config:
  """MT3 finetuning recipe (reference gin/ismir2022/finetune.gin)."""
  base = mt3_config()
  run = dataclasses.replace(
      base.run, train_steps=150000, batch_size=256, label_smoothing=0.0)
  return dataclasses.replace(base, name='mt3_finetune', run=run)


CONFIG_FACTORIES = {
    'mt3': mt3_config,
    'ismir2021': ismir2021_config,
    'mt3_pretrain': mt3_pretrain_config,
    'mt3_finetune': mt3_finetune_config,
    'tiny': tiny_config,
}
