"""CLI: transcribe audio files to MIDI with the PyTorch port.

Usage:
  python -m mt3_tpu_torch.cli.transcribe --model mt3 \
      input1.wav [input2.wav ...] --output_dir out/

Mirrors mt3_tpu/cli/transcribe.py.  Runs on CUDA unless --device cpu is
given.  Without a checkpoint the weights are random (torch seed 0).
Checkpoint import, int8 KV caches and grouped-query attention are accepted
as flags and raise NotImplementedError until their ROADMAP.md items land.
"""

from __future__ import annotations

import argparse
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
                      help='int8 decode KV caches (not ported yet)')
  parser.add_argument('--gqa_kv_heads', type=int, default=0,
                      help='grouped-query attention (not ported yet)')
  parser.add_argument('--convert_gqa_unfinetuned', action='store_true',
                      help='with --gqa_kv_heads (not ported yet)')
  parser.add_argument('--device', default=None,
                      help="torch device (default: cuda; 'cpu' to run "
                           'on the CPU)')
  args = parser.parse_args(argv)

  from mt3_tpu_torch import load_transcriber
  from mt3_tpu_torch import params as params_lib
  from mt3_tpu_torch.core import midi_io
  from mt3_tpu_torch.data.datasets import read_wav

  if args.checkpoint or args.t5x_checkpoint:
    raise NotImplementedError(params_lib.CHECKPOINTS_NOT_PORTED)
  if args.int8_kv:
    raise NotImplementedError(
        '--int8_kv: quantized decode caches are not ported yet (ROADMAP.md, '
        'modules to port: production decode variants)')
  if args.gqa_kv_heads or args.convert_gqa_unfinetuned:
    raise NotImplementedError(
        '--gqa_kv_heads: grouped-query decode is not ported yet (ROADMAP.md, '
        'modules to port: production decode variants)')

  print('WARNING: no checkpoint given; using random weights',
        file=sys.stderr)
  transcriber = load_transcriber(args.model, device=args.device,
                                 temperature=args.temperature,
                                 num_beams=args.num_beams)
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
