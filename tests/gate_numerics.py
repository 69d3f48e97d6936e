"""Why tests/test_int8_quality.py's gate reads otherwise on the port's model.

Not a test: a diagnostic that prints numbers, about 5 minutes on the CPU.

    JAX_PLATFORMS=cpu python -m tests.gate_numerics

On the CPU, from the same 400 pipeline batches, it trains the JAX
package's gate model (tests/test_int8_quality.py:25-78, bf16, stopped at
accuracy 0.75) and the port's from the JAX model's initial parameters,
then prints:
1. onset F1 of bf16, int8 and int4_cross for each trained model on the
   gate's 2 clips (JAX through its evaluator, the port through
   tools/quality_gates.gate_row);
2. the JAX-trained parameters scored by the port, once with the port's
   log-mel and once with the JAX package's log-mel fed in its place;
3. the largest difference between the two packages' float32 log-mels of
   those clips, and where it falls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mt3_tpu.codec import vocabulary
from mt3_tpu.core import config as jax_config
from mt3_tpu.data import datasets, pipeline
from mt3_tpu.eval import evaluator
from mt3_tpu.infer import transcribe
from mt3_tpu.ops import spectrogram as jax_spectrogram
from mt3_tpu.train import trainer as jax_trainer
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as port_config
from mt3_tpu_torch.data import datasets as port_datasets
from mt3_tpu_torch.ops import spectrogram as port_spectrogram
from mt3_tpu_torch.tools import quality_gates
from mt3_tpu_torch.train import trainer as port_trainer

ROWS = ('bf16', 'int8', 'int4_cross')
CLIPS = dict(num_examples=2, duration=2.0, seed=21, polyphony=1)


def configs():
  """tests/test_int8_quality.py's configuration, in both packages."""
  vocab_config = jax_config.VocabularyConfig(num_velocity_bins=1)
  vocab = vocabulary.vocabulary_from_codec(
      vocabulary.build_codec(vocab_config))
  model = jax_config.ModelConfig(
      vocab_size=vocabulary.num_embeddings(vocab), emb_dim=128, num_heads=4,
      num_encoder_layers=2, num_decoder_layers=2, head_dim=16, mlp_dim=256,
      dropout_rate=0.0, input_depth=512, max_positions=512,
      dtype='bfloat16')
  run = jax_config.RunConfig(inputs_length=128, targets_length=256,
                             batch_size=8, learning_rate=3e-3,
                             warmup_steps=20, use_ties=True)
  jax_cfg = jax_config.MT3Config('int8gate', jax_config.SpectrogramConfig(),
                                 vocab_config, model, run)
  port_cfg = port_config.MT3Config(
      'int8gate', port_config.SpectrogramConfig(),
      port_config.VocabularyConfig(num_velocity_bins=1),
      port_config.ModelConfig(**dataclasses.asdict(model)),
      port_config.RunConfig(**dataclasses.asdict(run)))
  return jax_cfg, port_cfg


def train(step_fn, batches):
  """tests/test_int8_quality.py's loop: stop once the accuracy read every
  25 steps reaches 0.75, at most 400 steps."""
  accuracy = 0.0
  for step, batch in enumerate(batches):
    metrics = step_fn(batch)
    if step % 25 == 24:
      accuracy = float(metrics['accuracy'])
      if accuracy >= 0.75:
        break
  return step + 1, accuracy


def jax_rows(cfg, params, examples):
  out = {}
  for name in ROWS:
    model = jax_config.ModelConfig(
        **{**cfg.model.__dict__, **quality_gates.VARIANTS[name]})
    scores = evaluator.evaluate_dataset(examples, transcribe.Transcriber(
        dataclasses.replace(cfg, model=model), params))
    out[name] = round(float(scores['Onset F1']), 4)
  return out


def port_rows(cfg, params, examples):
  return {name: round(quality_gates.gate_row(
      cfg, params, examples, name, quality_gates.VARIANTS[name],
      device='cpu')['onset_f1'], 4) for name in ROWS}


def main():
  torch.set_num_threads(4)
  jax_cfg, port_cfg = configs()
  spec = jax_cfg.spectrogram
  codec = vocabulary.build_codec(jax_cfg.vocab)
  vocab = vocabulary.vocabulary_from_codec(codec)
  batches = [b for _, b in zip(range(400), pipeline.train_batches(
      datasets.SyntheticDataSource(num_examples=4, duration=2.0, seed=21,
                                   polyphony=1).examples(),
      spec, codec, vocab, pipeline.TrainPipelineConfig(
          inputs_length=128, targets_length=256, batch_size=8, seed=0)))]
  jax_examples = list(datasets.SyntheticDataSource(**CLIPS).examples())
  port_examples = list(port_datasets.SyntheticDataSource(**CLIPS).examples())

  trainer = jax_trainer.Trainer(model_config=jax_cfg.model,
                                run_config=jax_cfg.run)
  init = jax.tree_util.tree_map(np.asarray, trainer.state.params)

  def jax_step(batch):
    batch = dict(batch, encoder_input_tokens=jax_spectrogram.frames_to_logmel(
        jnp.asarray(batch['encoder_input_frames']), spec))
    return trainer.step(batch)
  steps, accuracy = train(jax_step, batches)
  trained = jax.tree_util.tree_map(np.asarray, trainer.state.params)
  print(f'JAX: {steps} steps, accuracy {accuracy:.4f}; onset F1 '
        f'{jax_rows(jax_cfg, trained, jax_examples)}')

  port = port_trainer.Trainer(port_cfg.model, port_cfg.run, device='cpu')
  port.load_params(params_lib.from_numpy_tree(init))
  steps, accuracy = train(lambda b: port.step(port_trainer.model_batch(
      b, port_cfg.spectrogram, 'cpu')), batches)
  params = params_lib.tree_map(lambda t: t.detach().clone(),
                               port.state.params)
  print(f'port from the JAX initial parameters: {steps} steps, accuracy '
        f'{accuracy:.4f}; onset F1 '
        f'{port_rows(port_cfg, params, port_examples)}')

  jax_trained = params_lib.from_numpy_tree(trained)
  print(f'the JAX-trained parameters scored by the port: onset F1 '
        f'{port_rows(port_cfg, jax_trained, port_examples)}')
  port_logmel = port_spectrogram.compute_logmel

  def jax_logmel(audio, config, *args, **kwargs):
    return torch.from_numpy(np.array(jax_spectrogram.compute_logmel(
        jnp.asarray(audio.numpy()), spec)))
  port_spectrogram.compute_logmel = jax_logmel
  try:
    print(f'... with the JAX package\'s log-mel in place of the port\'s: '
          f'onset F1 {port_rows(port_cfg, jax_trained, port_examples)}')
  finally:
    port_spectrogram.compute_logmel = port_logmel

  worst = (0.0, None)
  for i, example in enumerate(jax_examples):
    for batch in transcribe.audio_to_segments(example['audio'], jax_cfg):
      want = np.asarray(jax_spectrogram.frames_to_logmel(
          jnp.asarray(batch.frames), spec))
      got = port_spectrogram.frames_to_logmel(
          torch.from_numpy(batch.frames), port_cfg.spectrogram).numpy()
      diff = np.abs(got - want)
      if diff.max() > worst[0]:
        at = np.unravel_index(diff.argmax(), diff.shape)
        worst = (float(diff.max()),
                 (i, *map(int, at), float(want[at]), float(got[at])))
  clip, row, frame, mel, jax_value, port_value = worst[1]
  print(f'largest |port - JAX| float32 log-mel on the clips: '
        f'{worst[0]:.4f} (clip {clip}, segment {row}, frame {frame}, mel '
        f'bin {mel}: JAX {jax_value:.4f}, port {port_value:.4f}, log(eps) '
        f'{np.log(1e-5):.4f})')


if __name__ == '__main__':
  main()
