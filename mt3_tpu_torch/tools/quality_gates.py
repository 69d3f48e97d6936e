"""Quality gates on a trained checkpoint (held-out clips); port of
tools/quality_gates.py with its flags, rows and table.

Re-runs every decode-configuration gate against a trained checkpoint on the
held-out test split:

  bf16        unquantized decode (the quality reference point)
  int8        int8 self-attention KV cache
  int4_cross  int4 self-attn cache + int8 cross K/V (bench.py production)
  int8dot     int8 x int8 attention products with exact integer sums
  stacked     int4_cross with decode_cache_carry='stacked'
  beam4       beam search, num_beams=4 (the reference default decode fn)
  gqa1        mean-pooled 1-KV-head conversion (no finetune)

Prints one table of onset F1 / onset+offset F1 per configuration and the
delta vs bf16.  Gate: |delta onset F1| <= 0.02 for the quantized
configurations (the same threshold as tests/test_int8_quality.py).

Parameters come through train/checkpoint.load_params, so a checkpoint of
either package can be gated: the port's checkpoint_<step>.pt files or the
JAX package's orbax directories.  Runs on CUDA unless --device cpu.

Usage:
  python -m mt3_tpu_torch.tools.quality_gates \
      --checkpoint runs/mt3_flagship_torch/ckpt --data corpus/test --num 32 \
      [--gqa --gqa_checkpoint runs/gqa_ft_torch/ckpt]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as config_lib
from mt3_tpu_torch.data import datasets
from mt3_tpu_torch.device import resolve_device
from mt3_tpu_torch.eval import evaluator
from mt3_tpu_torch.infer import transcribe as transcribe_lib
from mt3_tpu_torch.train import checkpoint as ckpt_lib

VARIANTS = {
    'bf16': {},
    'int8': {'decode_kv_quantize': True},
    'int4_cross': {'decode_kv_quantize': True, 'decode_kv_bits': 4,
                   'decode_cross_kv_quantize': True},
    'int8dot': {'decode_kv_quantize': True,
                'decode_attention_impl': 'xla_int8dot'},
    'stacked': {'decode_kv_quantize': True, 'decode_kv_bits': 4,
                'decode_cross_kv_quantize': True,
                'decode_cache_carry': 'stacked'},
}
# The 1-KV-head rows decode in the production configuration.
GQA_OVERRIDES = {'num_kv_heads': 1, 'decode_kv_quantize': True,
                 'decode_kv_bits': 4, 'decode_cross_kv_quantize': True}


def load_params(checkpoint_dir: str, model_config):
  params, path = ckpt_lib.load_params(checkpoint_dir, model_config)
  print(f'restoring {path}', file=sys.stderr)
  return params


def gate_row(config, params, examples, name, overrides, num_beams=1,
             dtype='bfloat16', device=None, tag=None):
  """Transcribe and score `examples` with `config`'s model in `dtype` with
  the decode `overrides`; returns the row the tool prints."""
  model_config = dataclasses.replace(config.model, dtype=dtype, **overrides)
  transcriber = transcribe_lib.Transcriber(
      dataclasses.replace(config, model=model_config), params,
      num_beams=num_beams, device=device)
  scores = evaluator.evaluate_dataset(examples, transcriber)
  return {'variant': name,
          **({'checkpoint': tag} if tag else {}),
          'onset_f1': scores['Onset F1'],
          'onset_offset_f1': scores['Onset & offset F1']
          if 'Onset & offset F1' in scores
          else scores.get('Onset + offset F1', 0.0),
          'frame_f1': scores.get('Frame F1', 0.0),
          'onset_velocity_f1': scores.get('Onset + velocity F1', 0.0)}


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--checkpoint', required=True)
  parser.add_argument('--model', default='mt3')
  parser.add_argument('--data', default='corpus/test')
  parser.add_argument('--num', type=int, default=32)
  parser.add_argument('--variants',
                      default=','.join(VARIANTS) + ',beam4')
  parser.add_argument('--gqa', action='store_true',
                      help='also gate the mean-pooled 1-KV-head '
                           'conversion (no finetune)')
  parser.add_argument('--gqa_checkpoint', default=None,
                      help='a finetuned GQA checkpoint to gate as '
                           "'gqa1_ft' (params stored with 1 KV head)")
  parser.add_argument('--out', default=None,
                      help='append one JSON line per variant here')
  parser.add_argument('--tag', default=None,
                      help='checkpoint tag recorded in each output row '
                           '(e.g. checkpoint_21061)')
  parser.add_argument('--device', default=None,
                      help="torch device (default: cuda; 'cpu' to run on "
                           'the CPU)')
  args = parser.parse_args(argv)
  device = resolve_device(args.device)

  base = config_lib.CONFIG_FACTORIES[args.model]()
  source = datasets.resolve_data_source(args.data, base.spectrogram,
                                        num_examples=args.num)
  examples = list(source.examples())[:args.num]
  print(f'{len(examples)} held-out clips from {args.data}',
        file=sys.stderr)

  mha_params = load_params(args.checkpoint,
                           dataclasses.replace(base.model,
                                               num_kv_heads=None))

  def run(name, overrides, params=None, num_beams=1):
    row = gate_row(base, mha_params if params is None else params, examples,
                   name, overrides, num_beams=num_beams, device=device,
                   tag=args.tag)
    print(json.dumps(row), flush=True)
    return row

  rows = []
  for name in args.variants.split(','):
    if name == 'beam4':
      # Beam search (the reference model's default decode fn) on the
      # unquantized cache.
      rows.append(run(name, {}, num_beams=4))
    else:
      rows.append(run(name, VARIANTS[name]))

  if args.gqa:
    # Deliberately measures the unfinetuned conversion collapse.
    gqa_params = params_lib.convert_mha_to_gqa(
        mha_params, base.model.num_heads, base.model.head_dim, 1,
        allow_unfinetuned=True)
    rows.append(run('gqa1', GQA_OVERRIDES, params=gqa_params))
  if args.gqa_checkpoint:
    gqa_ft = load_params(
        args.gqa_checkpoint,
        dataclasses.replace(base.model, num_kv_heads=1))
    rows.append(run('gqa1_ft', GQA_OVERRIDES, params=gqa_ft))

  ref = next((r for r in rows if r['variant'] == 'bf16'), rows[0])
  print(f'\n{"variant":12s} {"onset F1":>9s} {"on+off F1":>9s} '
        f'{"frame F1":>9s} {"d(onset)":>9s}')
  for r in rows:
    print(f'{r["variant"]:12s} {r["onset_f1"]:9.4f} '
          f'{r["onset_offset_f1"]:9.4f} {r["frame_f1"]:9.4f} '
          f'{r["onset_f1"] - ref["onset_f1"]:+9.4f}')
  if args.out:
    with open(args.out, 'a') as f:
      for r in rows:
        f.write(json.dumps(r) + '\n')


if __name__ == '__main__':
  main()
