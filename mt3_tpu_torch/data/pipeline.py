"""Host-side training data pipeline (copy of the train chain of
mt3_tpu/data/pipeline.py).

Plain-NumPy functions over feature dicts plus generator-based dataset
stages, rebuilding the seqio/t5.data preprocessor chain the reference
assembles in mt3/tasks.py:135-181:

  tokenize -> split_tokens(<=2000 frames) -> select_random_chunk ->
  extract_target_sequence_with_indices -> map_midi_programs ->
  run_length_encode_shifts -> [mix] -> remove_redundant_state_changes ->
  append EOS -> convert to model features.

Batches carry raw audio frames; the log-mel spectrogram runs on the device
in the train step (ops/spectrogram.frames_to_logmel).  Each function is a
copy of the JAX package's, with imports rewritten, and a test pins it to
its original.  The segment cache, TFRecord readers and the eval chain are
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from mt3_tpu_torch.codec import event_codec, note_events, run_length, vocabulary
from mt3_tpu_torch.core.config import SpectrogramConfig
from mt3_tpu_torch.core.note_sequence import NoteSequence
from mt3_tpu_torch.core import sustain

Features = Dict[str, Any]

MAX_NUM_CACHED_FRAMES = 2000


def audio_to_frames(samples: np.ndarray, config: SpectrogramConfig):
  """Pad audio to a hop-width multiple and split into frames + times."""
  samples = np.asarray(samples, np.float32)
  frame_size = config.hop_width
  samples = np.pad(samples,
                   [0, frame_size - len(samples) % frame_size])
  frames = samples.reshape(-1, frame_size)
  times = np.arange(len(frames)) / config.frames_per_second
  return frames, times


def tokenize_example(
    ns: NoteSequence,
    samples: np.ndarray,
    spectrogram_config: SpectrogramConfig,
    codec: event_codec.Codec,
    onsets_only: bool = False,
    include_ties: bool = True,
    apply_sustain: bool = True,
) -> Features:
  """NoteSequence + audio -> frames, target events, and frame index maps."""
  if onsets_only and include_ties:
    raise ValueError('Ties not supported when only modeling onsets.')
  note_events.validate_note_sequence(ns)
  frames, frame_times = audio_to_frames(samples, spectrogram_config)

  if onsets_only:
    times, values = note_events.note_sequence_to_onsets(ns)
  else:
    if apply_sustain:
      ns = sustain.apply_sustain_control_changes(ns)
    times, values = (
        note_events.note_sequence_to_onsets_and_offsets_and_programs(ns))

  (events, event_start_indices, event_end_indices,
   state_events, state_event_indices) = run_length.encode_and_index_events(
       state=note_events.NoteEncodingState() if include_ties else None,
       event_times=times,
       event_values=values,
       encode_event_fn=note_events.note_event_data_to_events,
       codec=codec,
       frame_times=frame_times,
       encoding_state_to_events_fn=(
           note_events.note_encoding_state_to_events
           if include_ties else None))

  return {
      'inputs': frames,
      'input_times': frame_times,
      'targets': events,
      'input_event_start_indices': event_start_indices,
      'input_event_end_indices': event_end_indices,
      'state_events': state_events,
      'input_state_event_indices': state_event_indices,
      'sequence': ns,
  }


_SPLIT_KEYS = ('inputs', 'input_event_start_indices',
               'input_event_end_indices', 'input_state_event_indices')

def split_tokens(features: Features,
                 max_tokens: int = MAX_NUM_CACHED_FRAMES,
                 additional_keys: Sequence[str] = _SPLIT_KEYS[1:],
                 key: str = 'inputs') -> List[Features]:
  """Split the frame axis into chunks of at most max_tokens."""
  n = len(features[key])
  chunks = []
  for lo in range(0, n, max_tokens):
    hi = min(lo + max_tokens, n)
    chunk = dict(features)
    chunk[key] = features[key][lo:hi]
    for k in additional_keys:
      chunk[k] = features[k][lo:hi]
    chunks.append(chunk)
  return chunks


def select_random_chunk(features: Features, length: int,
                        rng: np.random.RandomState,
                        additional_keys: Sequence[str] = _SPLIT_KEYS[1:],
                        key: str = 'inputs') -> Features:
  """Uniform-random-start crop of `length` frames (may be shorter)."""
  n = len(features[key])
  if n <= length:
    return dict(features)
  start = int(rng.randint(0, n - length + 1))
  out = dict(features)
  out[key] = features[key][start:start + length]
  for k in additional_keys:
    out[k] = features[k][start:start + length]
  return out


def map_midi_programs(tokens: np.ndarray, codec: event_codec.Codec,
                      granularity_type: str = 'full') -> np.ndarray:
  granularity = vocabulary.PROGRAM_GRANULARITIES[granularity_type]
  return granularity.tokens_map_fn(np.asarray(tokens), codec)


def encode_targets(tokens: np.ndarray,
                   vocab: vocabulary.GenericTokenVocabulary,
                   append_eos: bool = True) -> np.ndarray:
  """Codec indices -> model ids (+EOS)."""
  encoded = vocab.encode_array(np.asarray(tokens, np.int32))
  if append_eos:
    encoded = np.concatenate(
        [encoded, [vocab.eos_id]]).astype(np.int32)
  return encoded.astype(np.int32)


def crop_and_rle(
    features: Features,
    codec: event_codec.Codec,
    inputs_length: int,
    rng: np.random.RandomState,
    include_ties: bool = True,
    program_granularity: str = 'full',
) -> Features:
  """Random crop + tie-section extraction + absolute-step RLE.

  First half of the train chain, up to the point where the reference
  mixes examples (tasks.py:161-166: ...run_length_encode_shifts ->
  mix_transcription_examples -> remove_redundant_state_changes...).
  Returns {'inputs': frames, 'targets': RLE codec tokens}.
  """
  tie_token = codec.encode_event(event_codec.Event('tie', 0))
  chunk = select_random_chunk(features, inputs_length, rng)
  chunk = run_length.extract_target_sequence_with_indices(
      chunk, state_events_end_token=tie_token if include_ties else None)
  tokens = map_midi_programs(chunk['targets'], codec, program_granularity)
  tokens = run_length.run_length_encode_shifts(tokens, codec)
  return {'inputs': chunk['inputs'], 'targets': tokens}


def finalize_train_example(
    cropped: Features,
    codec: event_codec.Codec,
    vocab: vocabulary.GenericTokenVocabulary,
    inputs_length: int,
    targets_length: int,
    skip_too_long: bool = True,
) -> Optional[Features]:
  """Second half of the train chain: dedup state changes, encode + EOS,
  pad, and build the autoregressive shift.  Returns None if the example
  should be skipped (targets too long)."""
  tokens = run_length.remove_redundant_state_changes(
      cropped['targets'], codec,
      state_change_event_types=['velocity', 'program'])
  targets = encode_targets(tokens, vocab)

  if len(targets) > targets_length:
    if skip_too_long:
      return None
    raise ValueError(
        f'targets length {len(targets)} exceeds {targets_length}')

  frames = cropped['inputs']
  n_frames = len(frames)
  if n_frames < inputs_length:
    frames = np.pad(frames, [(0, inputs_length - n_frames), (0, 0)])
  elif n_frames > inputs_length:
    # Mixing can produce a group whose longest member sets the frame
    # count; clip to the model's input length.
    frames = frames[:inputs_length]
  padded_targets = np.zeros(targets_length, np.int32)
  padded_targets[:len(targets)] = targets

  decoder_input = np.zeros(targets_length, np.int32)
  decoder_input[1:len(targets)] = targets[:-1]

  return {
      'encoder_input_frames': frames.astype(np.float32),
      'decoder_target_tokens': padded_targets,
      'decoder_input_tokens': decoder_input,
      'decoder_loss_weights': (padded_targets > 0).astype(np.int32),
  }


def _stack_batch(batch: List[Features]) -> Dict[str, np.ndarray]:
  return {
      'encoder_input_frames': np.stack(
          [b['encoder_input_frames'] for b in batch]),
      'decoder_target_tokens': np.stack(
          [b['decoder_target_tokens'] for b in batch]),
      'decoder_input_tokens': np.stack(
          [b['decoder_input_tokens'] for b in batch]),
      'decoder_loss_weights': np.stack(
          [b['decoder_loss_weights'] for b in batch]),
  }


def prefetch(iterator: Iterator, size: int = 2,
             transform=None) -> Iterator:
  """Run `iterator` in a background thread with a bounded queue.

  The tf.data-style host/device overlap: batch preparation proceeds
  while the previous step executes on the accelerator.  `transform`
  (e.g. jax.device_put or a device-staging batch converter) also runs on
  the producer thread, so host->device transfers overlap the previous
  step instead of serializing with it.
  """
  import queue
  import threading

  q: 'queue.Queue' = queue.Queue(maxsize=size)
  sentinel = object()

  def producer():
    try:
      for item in iterator:
        q.put(transform(item) if transform is not None else item)
    finally:
      q.put(sentinel)

  thread = threading.Thread(target=producer, daemon=True)
  thread.start()
  while True:
    item = q.get()
    if item is sentinel:
      return
    yield item


@dataclasses.dataclass
class TrainPipelineConfig:
  inputs_length: int
  targets_length: int
  batch_size: int
  onsets_only: bool = False
  include_ties: bool = True
  program_granularity: str = 'full'
  # Randomly mix groups of 1..N examples (audio sum + RLE target merge,
  # reference mixing.py / gin/ismir2022/pretrain.gin MAX_EXAMPLES_PER_MIX=8).
  max_examples_per_mix: Optional[int] = None
  seed: int = 0


def train_batches(
    examples: Iterable[Features],
    spectrogram_config: SpectrogramConfig,
    codec: event_codec.Codec,
    vocab: vocabulary.GenericTokenVocabulary,
    pipeline_config: TrainPipelineConfig,
) -> Iterator[Dict[str, np.ndarray]]:
  """Infinite batch iterator over (ns, audio) example dicts.

  `examples` yields dicts with 'sequence' (NoteSequence) and 'audio'
  (float32 samples); tokenization and cache-chunking run once per epoch
  pass, random crops re-randomize each visit.
  """
  rng = np.random.RandomState(pipeline_config.seed)

  # Tokenize + cache-split once (the seqio offline-cache analog).
  cached_chunks: List[Features] = []
  for example in examples:
    features = tokenize_example(
        example['sequence'], example['audio'], spectrogram_config, codec,
        onsets_only=pipeline_config.onsets_only,
        include_ties=pipeline_config.include_ties)
    cached_chunks.extend(split_tokens(features))
  if not cached_chunks:
    raise ValueError('no examples to train on')

  def epoch(rng):
    for idx in rng.permutation(len(cached_chunks)):
      yield cached_chunks[idx]

  yield from _batches_over_epochs(epoch, codec, vocab, pipeline_config,
                                  rng)


def _batches_over_epochs(epoch_fn, codec, vocab, pipeline_config, rng
                         ) -> Iterator[Dict[str, np.ndarray]]:
  """Crop -> [mix] -> finalize -> batch, over endless epochs."""
  from mt3_tpu_torch.data import mixing
  batch = []
  while True:
    cropped = (crop_and_rle(
        seg, codec, pipeline_config.inputs_length, rng,
        include_ties=pipeline_config.include_ties,
        program_granularity=pipeline_config.program_granularity)
        for seg in epoch_fn(rng))
    if pipeline_config.max_examples_per_mix:
      cropped = mixing.mix_transcription_examples(
          cropped, codec, pipeline_config.max_examples_per_mix, rng)
    for ex_cropped in cropped:
      ex = finalize_train_example(
          ex_cropped, codec, vocab, pipeline_config.inputs_length,
          pipeline_config.targets_length)
      if ex is None:
        continue
      batch.append(ex)
      if len(batch) == pipeline_config.batch_size:
        yield _stack_batch(batch)
        batch = []
