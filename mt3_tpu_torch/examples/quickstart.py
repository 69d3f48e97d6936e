"""Quickstart: train a small model on synthetic music and transcribe it
(port of examples/quickstart.py: the same configuration, clip, steps and
outputs).

No checkpoints or datasets needed: a small model is overfit to one
procedurally generated clip, then run through the full transcription stack
(log-mel -> encoder -> KV-cached decode -> tie-aware stitching -> MIDI
file).  Runs on CUDA unless a device is given.

Run:  python -m mt3_tpu_torch.examples.quickstart [output_dir [device]]
"""

import os
import sys

from mt3_tpu_torch.codec import vocabulary
from mt3_tpu_torch.core import midi_io
from mt3_tpu_torch.core.config import (MT3Config, ModelConfig, RunConfig,
                                       SpectrogramConfig, VocabularyConfig)
from mt3_tpu_torch.data import datasets, pipeline
from mt3_tpu_torch.device import resolve_device
from mt3_tpu_torch.eval import evaluator, summaries
from mt3_tpu_torch.infer import transcribe as transcribe_lib
from mt3_tpu_torch.train import trainer as trainer_lib

STEPS = 150


def config():
  """The quickstart model: emb 128, 4 heads x 16, 2+2 layers, one velocity
  bin, ties, 256 input frames, 160 targets, batch 4, lr 3e-3."""
  spec_config = SpectrogramConfig()
  vocab_config = VocabularyConfig(num_velocity_bins=1)
  vocab = vocabulary.vocabulary_from_codec(
      vocabulary.build_codec(vocab_config))
  model_config = ModelConfig(
      vocab_size=vocabulary.num_embeddings(vocab), emb_dim=128,
      num_heads=4, num_encoder_layers=2, num_decoder_layers=2,
      head_dim=16, mlp_dim=256, dropout_rate=0.0, input_depth=512,
      max_positions=512)
  run_config = RunConfig(inputs_length=256, targets_length=160,
                         batch_size=4, learning_rate=3e-3,
                         warmup_steps=10, use_ties=True)
  return MT3Config('quickstart', spec_config, vocab_config,
                   model_config, run_config)


def example():
  """The clip: 2 s of one synthetic voice (seed 11)."""
  source = datasets.SyntheticDataSource(num_examples=1, duration=2.0,
                                        seed=11, polyphony=1)
  return next(source.examples())


def first_batch(cfg, clip):
  """The pipeline batch the model is overfit to."""
  codec = vocabulary.build_codec(cfg.vocab)
  vocab = vocabulary.vocabulary_from_codec(codec)
  run_config = cfg.run
  pipe_cfg = pipeline.TrainPipelineConfig(
      inputs_length=run_config.inputs_length,
      targets_length=run_config.targets_length,
      batch_size=run_config.batch_size)
  return next(pipeline.train_batches([clip], cfg.spectrogram, codec, vocab,
                                     pipe_cfg))


def train(device=None, steps=STEPS):
  """Builds the model and overfits it to the clip; (config, example,
  trainer)."""
  device = resolve_device(device)
  cfg = config()
  clip = example()
  tr = trainer_lib.Trainer(model_config=cfg.model, run_config=cfg.run,
                           device=device)
  model_batch = trainer_lib.model_batch(first_batch(cfg, clip),
                                        cfg.spectrogram, device)
  print('training (overfit on one clip)...')
  for step in range(steps):
    metrics = tr.step(model_batch)
    if step % 30 == 0:
      print(f'  step {step}: loss={float(metrics["loss"]):.3f} '
            f'acc={float(metrics["accuracy"]):.3f}')
  return cfg, clip, tr


def main(output_dir='quickstart_out', device=None):
  os.makedirs(output_dir, exist_ok=True)
  cfg, clip, tr = train(device)
  summaries.write_wav(f'{output_dir}/input.wav', clip['audio'])

  print('transcribing...')
  transcriber = transcribe_lib.Transcriber(cfg, tr.state.params,
                                           device=tr.device)
  ns = transcriber(clip['audio'])
  midi_io.note_sequence_to_midi_file(ns, f'{output_dir}/transcribed.mid')
  summaries.write_wav(f'{output_dir}/resynth.wav',
                      summaries.synthesize(ns))
  summaries.save_png(f'{output_dir}/pianoroll.png',
                     summaries.pianoroll_image(ns, clip['sequence']))

  scores = evaluator.evaluate_dataset([clip], transcriber)
  print(f'{len(ns.notes)} notes; onset F1 = {scores["Onset F1"]:.3f}')
  print(f'outputs in {output_dir}/')


if __name__ == '__main__':
  main(*sys.argv[1:3])
