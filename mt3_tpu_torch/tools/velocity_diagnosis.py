"""Diagnose the onset+velocity F1 gap; port of tools/velocity_diagnosis.py
with its flags and JSON keys.

Held-out onset+velocity F1 sits far below onset F1 on the mt3-flavor
model even though the synthetic corpus randomizes velocity 48-127.  This
tool settles whether that is (a) a bug in the velocity path, (b) the strict
mir_eval velocity criterion, or (c) structural — the mt3 flavor's
vocabulary has num_velocity_bins=1 (reference gin/mt3.gin:7), so every
decoded note carries the same velocity and the mir_eval least-squares
rescale can only ever pass the ~2*velocity_tolerance fraction of matched
notes whose normalized reference velocity lies near the fitted constant.

For each held-out clip: transcribe, onset-match predictions to reference
notes ignoring velocity (mir_eval semantics), then report
  - the distribution of predicted vs reference velocities over matches,
  - the measured fraction of onset matches that survive the velocity
    criterion, vs the theoretical cap for a constant predictor
    (2 * velocity_tolerance of the normalized reference range),
  - for multi-bin vocabularies (ismir2021, 127 bins): the velocity-bin
    confusion (quantized to 8 coarse bins), MAE in velocity units, and
    the same survival fraction.

Runs on CUDA unless --device cpu.

Usage:
  python -m mt3_tpu_torch.tools.velocity_diagnosis \
      --checkpoint runs/ismir2021_torch/ckpt --model ismir2021 \
      --data corpus_piano/test --num 16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from mt3_tpu_torch.core import config as config_lib
from mt3_tpu_torch.core.note_sequence import sequence_to_valued_intervals
from mt3_tpu_torch.data import datasets
from mt3_tpu_torch.device import resolve_device
from mt3_tpu_torch.eval import transcription
from mt3_tpu_torch.infer import transcribe as transcribe_lib
from mt3_tpu_torch.train import checkpoint as ckpt_lib

VELOCITY_TOLERANCE = 0.1  # mir_eval default


def drumless(ns):
  # Match the evaluator's headline-metric protocol (eval/metrics.py
  # _remove_drums): onset[+velocity] F1 is scored on non-drum notes;
  # drums are scored by the separate drum-onset metrics.  Without this,
  # all-drum synthetic clips pool into the matching here but score a flat
  # 0.0 in the evaluator (mir_eval convention for an empty drumless
  # reference).
  return dataclasses.replace(
      ns, notes=[n for n in ns.notes if not n.is_drum])


def diagnose(examples, transcribe_fn, num_velocity_bins):
  """The diagnosis of `transcribe_fn` (audio -> NoteSequence) over
  `examples` ({'audio', 'sequence'} dicts), as the JSON object the tool
  prints."""
  ref_vels, est_vels = [], []
  n_ref = n_est = n_onset_matched = n_vel_survived = 0
  n_clips_scored = 0
  for example in examples:
    est_ns = transcribe_fn(example['audio'])
    ri, rp, rv = sequence_to_valued_intervals(drumless(example['sequence']))
    ei, ep, ev = sequence_to_valued_intervals(drumless(est_ns))
    n_ref += len(rp)
    n_est += len(ep)
    if not len(rp) or not len(ep):
      continue
    n_clips_scored += 1
    onset_matches = transcription.match_notes(
        ri, rp, ei, ep, offset_ratio=None)
    vel_matches = transcription.match_notes_with_velocity(
        ri, rp, rv, ei, ep, ev, offset_ratio=None,
        velocity_tolerance=VELOCITY_TOLERANCE)
    n_onset_matched += len(onset_matches)
    n_vel_survived += len(vel_matches)
    for r_idx, e_idx in onset_matches:
      ref_vels.append(float(rv[r_idx]))
      est_vels.append(float(ev[e_idx]))

  ref_vels = np.asarray(ref_vels)
  est_vels = np.asarray(est_vels)
  survival = n_vel_survived / max(1, n_onset_matched)
  onset_p = n_onset_matched / max(1, n_est)
  onset_r = n_onset_matched / max(1, n_ref)
  onset_f1 = transcription.f_measure(onset_p, onset_r)
  vel_f1 = transcription.f_measure(
      n_vel_survived / max(1, n_est), n_vel_survived / max(1, n_ref))

  result = {
      'velocity_bins': num_velocity_bins,
      'melodic_clips_scored': int(n_clips_scored),
      'onset_matched_pairs': int(n_onset_matched),
      'onset_f1': round(onset_f1, 4),
      'onset_vel_f1': round(vel_f1, 4),
      'velocity_survival_fraction': round(survival, 4),
      'est_velocity_distinct_values': sorted(set(est_vels.tolist())),
      'ref_velocity_range': [float(ref_vels.min()), float(ref_vels.max())]
      if len(ref_vels) else None,
  }
  if len(set(est_vels.tolist())) <= 1:
    # Constant predictor: the survival cap is the fraction of normalized
    # reference velocities within +/-tolerance of the best constant.
    if len(ref_vels):
      norm = (ref_vels - ref_vels.min()) / max(1.0, np.ptp(ref_vels))
      caps = [np.mean(np.abs(norm - c) < VELOCITY_TOLERANCE)
              for c in np.linspace(0, 1, 101)]
      result['constant_predictor_cap'] = round(float(max(caps)), 4)
      result['diagnosis'] = (
          'structural: single-velocity-bin vocabulary decodes a constant '
          'velocity; onset+velocity F1 is capped at '
          f'~{max(caps):.2f} x onset F1 by the mir_eval tolerance')
  else:
    err = np.abs(est_vels - ref_vels)
    result['velocity_mae'] = round(float(err.mean()), 2)
    # 8-bin coarse confusion over the reference velocity range.
    lo, hi = ref_vels.min(), ref_vels.max() + 1e-9
    edges = np.linspace(lo, hi, 9)
    rbin = np.clip(np.digitize(ref_vels, edges) - 1, 0, 7)
    ebin = np.clip(np.digitize(est_vels, edges) - 1, 0, 7)
    conf = np.zeros((8, 8), int)
    np.add.at(conf, (rbin, ebin), 1)
    result['confusion_rows_ref_cols_est'] = conf.tolist()
    result['confusion_diag_fraction'] = round(
        float(np.trace(conf)) / max(1, conf.sum()), 4)
  return result


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--checkpoint', required=True)
  parser.add_argument('--model', default='mt3')
  parser.add_argument('--data', default='corpus/test')
  parser.add_argument('--num', type=int, default=16)
  parser.add_argument('--out', default=None)
  parser.add_argument('--device', default=None,
                      help="torch device (default: cuda; 'cpu' to run on "
                           'the CPU)')
  args = parser.parse_args(argv)
  device = resolve_device(args.device)

  base = config_lib.CONFIG_FACTORIES[args.model]()
  config = dataclasses.replace(base, model=dataclasses.replace(
      base.model, dtype='bfloat16'))
  params, _ = ckpt_lib.load_params(args.checkpoint, config.model)
  transcriber = transcribe_lib.Transcriber(config, params, device=device)

  source = datasets.resolve_data_source(args.data, base.spectrogram,
                                        num_examples=args.num)
  examples = list(source.examples())[:args.num]
  print(f'{len(examples)} clips from {args.data}; '
        f'{base.vocab.num_velocity_bins} velocity bin(s)', file=sys.stderr)

  result = diagnose(examples, transcriber, base.vocab.num_velocity_bins)
  print(json.dumps(result, indent=2))
  if args.out:
    with open(args.out, 'a') as f:
      f.write(json.dumps(result) + '\n')


if __name__ == '__main__':
  main()
