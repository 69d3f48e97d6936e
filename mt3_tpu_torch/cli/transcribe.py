"""CLI: transcribe audio files to MIDI with the PyTorch port.

Usage:
  python -m mt3_tpu_torch.cli.transcribe --model mt3 \
      input1.wav [input2.wav ...] --output_dir out/

Mirrors mt3_tpu/cli/transcribe.py.  Runs on CUDA unless --device cpu is
given.  Without a checkpoint the weights are random (torch seed 0):
--gqa_kv_heads N draws GQA-shaped weights, and with
--convert_gqa_unfinetuned MHA weights mean-pooled to N K/V heads.
--int8_kv quantizes the self-attention cache and the cross-attention K/V
to int8.  Checkpoint import is accepted as a flag and raises
NotImplementedError until its ROADMAP.md item lands.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from mt3_tpu_torch.core.config import CONFIG_FACTORIES


def main(argv=None):
  parser = argparse.ArgumentParser(description='Audio -> MIDI transcription')
  parser.add_argument('inputs', nargs='+', help='input .wav files')
  parser.add_argument('--model', default='mt3',
                      choices=sorted(CONFIG_FACTORIES))
  parser.add_argument('--checkpoint', default=None,
                      help='checkpoint directory (not ported yet)')
  parser.add_argument('--t5x_checkpoint', default=None,
                      help='published T5X checkpoint (not ported yet)')
  parser.add_argument('--output_dir', default='.')
  parser.add_argument('--temperature', type=float, default=0.0)
  parser.add_argument('--num_beams', type=int, default=0,
                      help='>1 enables beam search (not ported yet)')
  parser.add_argument('--int8_kv', action='store_true',
                      help='int8-quantize the decode self-attention cache '
                           'and the cross-attention K/V')
  parser.add_argument('--gqa_kv_heads', type=int, default=0,
                      help='grouped-query attention with N KV heads '
                           '(GQA-shaped weights)')
  parser.add_argument('--convert_gqa_unfinetuned', action='store_true',
                      help='with --gqa_kv_heads: mean-pool MHA weights to '
                           'GQA without the recovery finetune the JAX '
                           'package requires (quality collapses; '
                           'debugging only)')
  parser.add_argument('--device', default=None,
                      help="torch device (default: cuda; 'cpu' to run "
                           'on the CPU)')
  args = parser.parse_args(argv)

  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.core import midi_io
  from mt3_tpu_torch.data.datasets import read_wav
  from mt3_tpu_torch.infer.transcribe import Transcriber

  if args.checkpoint or args.t5x_checkpoint:
    raise NotImplementedError(params_lib.CHECKPOINTS_NOT_PORTED)
  config = CONFIG_FACTORIES[args.model]()
  config = dataclasses.replace(config, model=dataclasses.replace(
      config.model, dtype='bfloat16', decode_kv_quantize=args.int8_kv,
      decode_cross_kv_quantize=args.int8_kv,
      **({'num_kv_heads': args.gqa_kv_heads} if args.gqa_kv_heads else {})))

  # With --convert_gqa_unfinetuned the weights are MHA-shaped and get
  # mean-pooled (debugging only: see the flag's help).
  convert_gqa = args.gqa_kv_heads and args.convert_gqa_unfinetuned
  load_model_config = (dataclasses.replace(config.model, num_kv_heads=None)
                       if convert_gqa else config.model)
  print('WARNING: no checkpoint given; using random weights',
        file=sys.stderr)
  params = params_lib.init_params(load_model_config)
  if convert_gqa:
    print(f'converting to GQA: {config.model.num_heads} -> '
          f'{args.gqa_kv_heads} KV heads (mean-pooled, UNFINETUNED: expect '
          'collapsed quality)', file=sys.stderr)
    params = params_lib.convert_mha_to_gqa(
        params, config.model.num_heads, config.model.head_dim,
        args.gqa_kv_heads, allow_unfinetuned=True)
  transcriber = Transcriber(config, params, temperature=args.temperature,
                            num_beams=args.num_beams, device=args.device)
  sample_rate = transcriber.config.spectrogram.sample_rate
  os.makedirs(args.output_dir, exist_ok=True)
  for path in args.inputs:
    audio = read_wav(path, sample_rate)
    start = time.time()
    ns = transcriber(audio)
    elapsed = time.time() - start
    out_path = os.path.join(
        args.output_dir,
        os.path.splitext(os.path.basename(path))[0] + '.mid')
    midi_io.note_sequence_to_midi_file(ns, out_path)
    audio_sec = len(audio) / sample_rate
    print(f'{path}: {audio_sec:.1f}s audio, {len(ns.notes)} notes, '
          f'{elapsed:.1f}s ({audio_sec / max(elapsed, 1e-9):.1f}x RT) '
          f'on {transcriber.device} -> {out_path}')


if __name__ == '__main__':
  main()
