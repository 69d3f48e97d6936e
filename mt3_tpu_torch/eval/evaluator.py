"""Evaluation driver: run chunked inference over a dataset, score it
(port of mt3_tpu/eval/evaluator.py).

Rebuild of the seqio.Evaluator flow the reference binds in
gin/train.gin:89-97 / gin/eval.gin:50-56: for each eval example, tile the
audio into segments, predict tokens for every segment, combine per
example, and feed the transcription metric family.  Example i samples
(at temperature > 0) from a torch.Generator seeded with i, where the JAX
package uses PRNGKey(i).
"""

from __future__ import annotations

import json
import time
from typing import Dict, Iterable, Optional

import torch

from mt3_tpu_torch.core.config import MT3Config
from mt3_tpu_torch.eval import metrics as metrics_lib
from mt3_tpu_torch.infer import transcribe


def evaluate_dataset(
    examples: Iterable[Dict],
    transcriber: transcribe.Transcriber,
    track_specs=None,
) -> Dict[str, float]:
  """Transcribe and score an iterable of {'sequence', 'audio'} examples."""
  config: MT3Config = transcriber.config
  codec = transcriber.codec
  targets = []
  predictions = []

  for unique_id, example in enumerate(examples):
    targets.append({'unique_id': unique_id,
                    'ref_ns': example['sequence']})
    predictions.extend(transcriber.predict_segments(
        example['audio'],
        generator=torch.Generator(device=transcriber.device).manual_seed(
            unique_id),
        unique_id=unique_id))

  return metrics_lib.transcription_metrics(
      targets, predictions, codec=codec,
      onsets_only=config.run.onsets_only,
      use_ties=config.run.use_ties,
      track_specs=track_specs)


def write_metrics(scores: Dict[str, float], path: Optional[str] = None,
                  step: Optional[int] = None) -> str:
  """Write metrics as a JSON line (the reference's JSON logger analog)."""
  record = {'timestamp': time.time()}
  if step is not None:
    record['step'] = step
  record.update({k: float(v) for k, v in scores.items()})
  line = json.dumps(record)
  if path:
    with open(path, 'a') as f:
      f.write(line + '\n')
  return line
