"""A throwaway benchmark root for CPU tests: the repository's gpubench
files and BENCHMARK.json, plus tiny cells that are new files only."""

from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]

# Limits of the tiny cells, under which their sound runs fall on the CPU.
LIMITS = {'tiny.bulk': {'logit_gap': 0.05}, 'tiny.clip': {'logit_gap': 0.05},
          'tiny.train': {'loss_gap': 1e-3, 'grad_gap': 0.05,
                         'change_gap': 0.05},
          'tiny.bulk_int4': {'logit_gap': 0.2}}
TINY_MODEL = {'vocab_size': 1536, 'emb_dim': 32, 'num_heads': 4, 'head_dim': 8,
              'num_encoder_layers': 2, 'num_decoder_layers': 2, 'mlp_dim': 32,
              'input_depth': 512, 'dropout_rate': 0.1, 'max_positions': 2048,
              'mlp_activations': ['gelu', 'linear'], 'num_kv_heads': None}
TRAFFIC = {
    'tiny_bulk': {'kind': 'bulk', 'segments': 8, 'forbid_eos': True,
                  'steps_per_check': 4, 'check_rows': 8,
                  'trace_from_index': 4, 'trace_steps': 4},
    'tiny_clip': {'kind': 'clip', 'clip_seconds': 0.3, 'pool': 2,
                  'infer_batch_size': 8, 'check_clips': 2,
                  'trace_from_index': 4, 'trace_steps': 4},
    'tiny_train': {'kind': 'train', 'batch': 4, 'ring': 4, 'remat': True,
                   'remat_policy': 'full', 'attention': 'flash',
                   'check_steps': 3, 'check_block_rows': 3},
}
CELLS = {'tiny.bulk': ('tiny_mt3', 'tiny_bulk'),
         'tiny.clip': ('tiny_piano', 'tiny_clip'),
         'tiny.train': ('tiny_mt3', 'tiny_train'),
         'tiny.bulk_int4': ('tiny_mt3_int4', 'tiny_bulk')}
# The cells that the control and the faults are shown on.
PLAIN = ('tiny.bulk', 'tiny.clip', 'tiny.train')
# A configuration with a quantized decode cache: int4 codes with float32
# scales for the self-attention cache, int8 cross-attention K/V.
INT4 = {'decode_kv_quantize': True, 'decode_kv_bits': 4,
        'decode_cross_kv_quantize': True}


def _config(base, model=None, **run):
  cfg = json.loads((REPO / 'gpubench' / 'configs' / f'{base}.json').read_text())
  cfg['name'] = f'tiny_{base}'
  cfg['model'] = dict(TINY_MODEL, vocab_size=cfg['model']['vocab_size'],
                      **(model or {}))
  cfg['run'].update(run)
  return cfg


def make_root(tmp: pathlib.Path, limits=None) -> pathlib.Path:
  """Copies gpubench/ and BENCHMARK.json under tmp and adds the tiny
  cells as new files and new entries."""
  root = tmp / 'bench'
  shutil.copytree(REPO / 'gpubench', root / 'gpubench',
                  ignore=shutil.ignore_patterns('__pycache__'))
  spec = json.loads((REPO / 'BENCHMARK.json').read_text())
  for name, cfg in (('tiny_mt3', _config('mt3', inputs_length=8,
                                          targets_length=16)),
                    ('tiny_piano', _config('ismir2021', inputs_length=8,
                                           targets_length=16)),
                    ('tiny_mt3_int4', _config('mt3', INT4, inputs_length=8,
                                              targets_length=16))):
    path = root / 'gpubench' / 'configs' / f'{name}.json'
    path.write_text(json.dumps(cfg))
    spec['configs'].append({'name': name, 'source': 'test', 'reduced': [],
                            'file': f'gpubench/configs/{name}.json',
                            'why': 'tiny'})
  for name, traffic in TRAFFIC.items():
    (root / 'gpubench' / 'traffic' / f'{name}.json').write_text(
        json.dumps(traffic))
  for cell, (config, traffic) in CELLS.items():
    spec['workloads'].append({'name': cell, 'config': config,
                              'traffic': traffic, 'chips': 1, 'why': 'tiny'})
    for metric in spec['end_to_end'] + spec['per_layer']:
      kind = TRAFFIC[traffic]['kind']
      twin = {'bulk': 'mt3.bulk_b3072', 'clip': 'ismir2021.clip30_b8',
              'train': 'mt3.train_b256'}[kind]
      if 'workloads' in metric and twin in metric['workloads']:
        metric['workloads'].append(cell)
    (root / 'gpubench' / 'limits' / f'{cell}.json').write_text(
        json.dumps((LIMITS if limits is None else limits).get(cell, {})))
  (root / 'BENCHMARK.json').write_text(json.dumps(spec))
  return root
