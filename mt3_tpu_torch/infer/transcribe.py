"""End-to-end transcription: waveform -> NoteSequence (port of
mt3_tpu/infer/transcribe.py).

  audio -> hop-width frames -> contiguous segments of inputs_length frames
  -> batched (log-mel -> encoder -> KV-cached decode) on the device
  -> vocabulary decode -> host-side segment stitching with tie sections.

Runs on CUDA unless the caller passes device='cpu'.  Beam search and the
JAX package's `mesh` argument are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.codec import note_events, vocabulary
from mt3_tpu_torch.core.config import MT3Config
from mt3_tpu_torch.core.note_sequence import NoteSequence
from mt3_tpu_torch.device import resolve_device
from mt3_tpu_torch.infer import decode, postprocess
from mt3_tpu_torch.models import t5
from mt3_tpu_torch.ops import spectrogram


@dataclasses.dataclass
class SegmentBatch:
  """A batch of audio segments ready for the device."""
  frames: np.ndarray        # [b, inputs_length, hop_width] float32
  start_times: List[float]  # segment start time (seconds) per row
  valid: List[bool]         # False for rows that are batch padding


def audio_to_segments(audio: np.ndarray, config: MT3Config,
                      overlap_frames: int = 0) -> Sequence[SegmentBatch]:
  """Split audio into batches of inputs_length-frame segments.

  overlap_frames > 0 strides segments by (inputs_length - overlap); 0 is
  the reference's contiguous tiling.
  """
  fps = config.spectrogram.frames_per_second
  seg_len = config.run.inputs_length
  batch_size = config.run.infer_batch_size
  stride = seg_len - overlap_frames
  if stride <= 0:
    raise ValueError('overlap must be smaller than the segment length')

  frames = spectrogram.split_audio(np.asarray(audio, np.float32),
                                   config.spectrogram)
  n_frames = frames.shape[0]
  n_segments = max(1, -(-max(n_frames - overlap_frames, 1) // stride))

  # Pad the frame axis so the last segment is full length.
  needed = (n_segments - 1) * stride + seg_len
  if needed > n_frames:
    frames = np.pad(frames, [(0, needed - n_frames), (0, 0)])

  segments = np.stack([frames[i * stride:i * stride + seg_len]
                       for i in range(n_segments)])
  start_times = [i * stride / fps for i in range(n_segments)]

  batches = []
  for i in range(0, n_segments, batch_size):
    chunk = segments[i:i + batch_size]
    times = start_times[i:i + batch_size]
    valid = [True] * len(chunk)
    if len(chunk) < batch_size:
      pad = batch_size - len(chunk)
      chunk = np.pad(chunk, [(0, pad), (0, 0), (0, 0)])
      times = times + [0.0] * pad
      valid = valid + [False] * pad
    batches.append(SegmentBatch(frames=chunk, start_times=times,
                                valid=valid))
  return batches


def _transcribe_batch(params, model_config, spec_config,
                      frames: torch.Tensor, max_decode_len: int,
                      temperature: float,
                      generator: Optional[torch.Generator],
                      num_beams: int = 0):
  """frames [b, len, hop] on the device -> (tokens, lengths) on the device."""
  if num_beams > 1:
    raise NotImplementedError(
        'beam search is not ported yet (ROADMAP.md, modules to port: beam '
        'search)')
  mel = spectrogram.compute_logmel(spectrogram.flatten_frames(frames),
                                   spec_config)
  encoded = t5.encode(params, model_config, mel)
  return decode.decode_tokens(
      params, model_config, encoded, max_decode_len,
      temperature=temperature, generator=generator,
      steps_per_iter=model_config.decode_steps_per_iter)


class Transcriber:
  """Audio -> NoteSequence transcription engine on one device."""

  def __init__(self, config: MT3Config, params, temperature: float = 0.0,
               num_beams: int = 0, device=None):
    self.device = resolve_device(device)
    self.config = config
    self.params = params_lib.to_device(params, self.device)
    self.temperature = temperature
    self.num_beams = num_beams
    self.codec = vocabulary.build_codec(config.vocab)
    self.vocab = vocabulary.vocabulary_from_codec(self.codec)
    if config.run.onsets_only:
      self.encoding_spec = note_events.NoteOnsetEncodingSpec
    elif config.run.use_ties:
      self.encoding_spec = note_events.NoteEncodingWithTiesSpec
    else:
      self.encoding_spec = note_events.NoteEncodingSpec

  def __call__(self, audio: np.ndarray,
               generator: Optional[torch.Generator] = None) -> NoteSequence:
    return self.transcribe(audio, generator=generator)['est_ns']

  def predict_segments(self, audio: np.ndarray,
                       generator: Optional[torch.Generator] = None,
                       unique_id: int = 0):
    """Per-segment token predictions for a waveform (postprocessed dicts)."""
    if self.temperature > 0.0 and generator is None:
      generator = torch.Generator(device=self.device).manual_seed(0)

    # Phase 1: run every batch on the device; tokens stay there.
    in_flight = []
    with torch.inference_mode():
      for batch in audio_to_segments(audio, self.config):
        frames = torch.from_numpy(batch.frames).to(self.device)
        tokens, _ = _transcribe_batch(
            self.params, self.config.model, self.config.spectrogram,
            frames, self.config.run.targets_length, self.temperature,
            generator, num_beams=self.num_beams)
        in_flight.append((batch, tokens))

    # Phase 2: fetch and decode on the host.
    predictions = []
    for batch, tokens in in_flight:
      decoded = self.vocab.decode_array(tokens.cpu().numpy())
      for row, start_time, valid in zip(decoded, batch.start_times,
                                        batch.valid):
        if not valid:
          continue
        predictions.append(postprocess.postprocess_prediction(
            row, start_time, self.codec,
            raw_inputs=np.zeros((0,), np.float32),
            unique_id=unique_id))
    return predictions

  def transcribe(self, audio: np.ndarray,
                 generator: Optional[torch.Generator] = None):
    """Transcribe a full waveform; returns the combined result dict."""
    predictions = self.predict_segments(audio, generator=generator)
    return postprocess.event_predictions_to_ns(
        predictions, self.codec, self.encoding_spec)
