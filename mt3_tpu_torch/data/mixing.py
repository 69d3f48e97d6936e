"""Audio-level example mixing (copy of mt3_tpu/data/mixing.py).

Rebuild of mt3/mixing.py:29-91: sample groups of 1..N
examples, sum their waveforms (normalized by the infinity norm), and merge
their run-length-encoded target streams in time order.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from mt3_tpu_torch.codec import event_codec, run_length


def mix_examples(group, codec: event_codec.Codec,
                 targets_key: str = 'targets',
                 inputs_key: str = 'inputs') -> Dict:
  """Mix a list of examples: sum audio frames, merge RLE targets."""
  if len(group) == 1:
    return dict(group[0])
  max_frames = max(len(ex[inputs_key]) for ex in group)
  max_targets = max(len(ex[targets_key]) for ex in group)

  samples = np.zeros((max_frames,) + group[0][inputs_key].shape[1:],
                     np.float32)
  padded_targets = np.zeros((len(group), max_targets), np.int32)
  for i, ex in enumerate(group):
    samples[:len(ex[inputs_key])] += ex[inputs_key]
    padded_targets[i, :len(ex[targets_key])] = ex[targets_key]

  norm = np.max(np.abs(samples))
  if norm > 0:
    samples = samples / norm

  merged = run_length.merge_run_length_encoded_targets(padded_targets,
                                                       codec)
  out = dict(group[0])
  out[inputs_key] = samples
  out[targets_key] = merged
  return out


def mix_transcription_examples(
    examples: Iterator[Dict],
    codec: event_codec.Codec,
    max_examples_per_mix: Optional[int] = None,
    rng: Optional[np.random.RandomState] = None,
) -> Iterator[Dict]:
  """Stream transform: randomly group 1..max examples and mix each group."""
  if max_examples_per_mix is None:
    yield from examples
    return
  rng = rng or np.random.RandomState(0)
  group = []
  group_size = int(rng.randint(1, max_examples_per_mix + 1))
  for ex in examples:
    group.append(ex)
    if len(group) >= group_size:
      yield mix_examples(group, codec)
      group = []
      group_size = int(rng.randint(1, max_examples_per_mix + 1))
  if group:
    yield mix_examples(group, codec)
