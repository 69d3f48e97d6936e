"""The port's quality gates against tools/quality_gates.py, on the CPU.

quality_gates.gate_row against the same composition on the JAX side (the
JAX Transcriber with the variant's overrides, then evaluate_dataset), in
float32, for each of the JAX tool's VARIANTS, beam4 and gqa1 (the last
three rows in tests/test_torch_quality_gates_decode.py, so that each file
stays short): equal F1s for bf16, beam4 and gqa1 (the same tokens),
within 0.02 for the quantized rows, whose codes may differ by one level
(ROADMAP §3).

The model has the tiny preset's widths; a random one writes only drum
notes, which the headline F1s leave out, so it is first trained for 150
steps on the port's CPU trainer (128 frames, 128 targets, 2 clips, as
examples/quickstart.py overfits its model), and the same parameters go to
both packages as numpy arrays (params.to_numpy_tree / from_numpy_tree).
Each clip's reference notes are the JAX package's float32 transcription
of it, so the bf16 row scores 1 and each other row how far its decode
strays from the unquantized one.  The JAX tool is loaded from tools/;
nothing there is edited.
"""

import dataclasses
import importlib.util
import pathlib
import sys

import jax
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.data import datasets as jax_datasets
from mt3_tpu.eval import evaluator as jax_evaluator
from mt3_tpu.infer import transcribe as jax_transcribe
from mt3_tpu.train import checkpoint as jax_ckpt
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.codec import vocabulary
from mt3_tpu_torch.core import config as port_config
from mt3_tpu_torch.core.note_sequence import Note
from mt3_tpu_torch.data import datasets as port_datasets
from mt3_tpu_torch.data import pipeline
from mt3_tpu_torch.tools import quality_gates
from mt3_tpu_torch.train import trainer as trainer_lib

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
QUANTIZED_TOL = 0.02
EXACT_ROWS = ('bf16', 'beam4', 'gqa1')
SCORES = ('onset_f1', 'onset_offset_f1', 'frame_f1', 'onset_velocity_f1')
CLIPS = dict(num_examples=2, duration=2.0, seed=5, polyphony=1)
TRAIN_STEPS = 150


def load_jax_tool(relative):
  """A tool of the JAX package from its file.  Loading it sets a JAX
  compile cache and puts the repository on sys.path; both are undone, so
  that later tests in this process see neither."""
  cache = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
  path = list(sys.path)
  try:
    spec = importlib.util.spec_from_file_location(
        f'jax_{pathlib.Path(relative).stem}', ROOT / relative)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
  finally:
    jax.config.update('jax_compilation_cache_dir', cache[0])
    jax.config.update('jax_persistent_cache_min_compile_time_secs', cache[1])
    sys.path[:] = path
  return module


@pytest.fixture(scope='module')
def jax_gates():
  return load_jax_tool('tools/quality_gates.py')


def _run(config_lib):
  return config_lib.RunConfig(
      **{**dataclasses.asdict(config_lib.tiny_config().run),
         'inputs_length': 128, 'targets_length': 128, 'batch_size': 4,
         'learning_rate': 3e-3, 'warmup_steps': 10})


@pytest.fixture(scope='module')
def setup():
  """(JAX config, numpy params, JAX clips, port config, port params, port
  clips): tiny widths, trained as the module docstring says."""
  cfg = dataclasses.replace(port_config.tiny_config(), run=_run(port_config))
  examples = list(port_datasets.SyntheticDataSource(**CLIPS).examples())
  codec = vocabulary.build_codec(cfg.vocab)
  batches = pipeline.train_batches(
      examples, cfg.spectrogram, codec,
      vocabulary.vocabulary_from_codec(codec), pipeline.TrainPipelineConfig(
          inputs_length=cfg.run.inputs_length,
          targets_length=cfg.run.targets_length,
          batch_size=cfg.run.batch_size, seed=0))
  trainer = trainer_lib.Trainer(cfg.model, cfg.run, device='cpu')
  for _ in range(TRAIN_STEPS):
    trainer.step(trainer_lib.model_batch(next(batches), cfg.spectrogram,
                                         'cpu'))
  numpy_params = params_lib.to_numpy_tree(trainer.state.params)

  jax_cfg = dataclasses.replace(jax_config.tiny_config(),
                                run=_run(jax_config))
  reference = jax_transcribe.Transcriber(jax_cfg, numpy_params)
  jax_examples = list(jax_datasets.SyntheticDataSource(**CLIPS).examples())
  for jax_ex, port_ex in zip(jax_examples, examples):
    ns = reference(jax_ex['audio'])
    assert any(not n.is_drum for n in ns.notes), ns
    jax_ex['sequence'] = ns
    port_ex['sequence'] = dataclasses.replace(
        port_ex['sequence'], total_time=ns.total_time,
        notes=[Note(**dataclasses.asdict(n)) for n in ns.notes])
  return (jax_cfg, numpy_params, jax_examples, cfg,
          params_lib.from_numpy_tree(numpy_params), examples)


def _jax_row(cfg, params, examples, name, overrides, num_beams):
  """tools/quality_gates.py's `run`, in float32."""
  model = jax_config.ModelConfig(
      **{**cfg.model.__dict__, 'dtype': 'float32', **overrides})
  config = jax_config.MT3Config(cfg.name, cfg.spectrogram, cfg.vocab, model,
                                cfg.run)
  scores = jax_evaluator.evaluate_dataset(
      examples, jax_transcribe.Transcriber(config, params,
                                           num_beams=num_beams))
  return {'variant': name, 'onset_f1': scores['Onset F1'],
          'onset_offset_f1': scores.get('Onset + offset F1', 0.0),
          'frame_f1': scores.get('Frame F1', 0.0),
          'onset_velocity_f1': scores.get('Onset + velocity F1', 0.0)}


def check_row(setup, jax_gates, name):
  """The port's row of `name` against the JAX composition's."""
  jax_cfg, jax_params, jax_examples, cfg, params, examples = setup
  overrides, beams = jax_gates.VARIANTS.get(name, {}), 1
  if name == 'beam4':
    beams = 4
  elif name == 'gqa1':
    overrides = quality_gates.GQA_OVERRIDES
    model = cfg.model
    jax_params = jax_ckpt.convert_mha_to_gqa(
        jax_params, model.num_heads, model.head_dim, 1,
        allow_unfinetuned=True)
    params = params_lib.convert_mha_to_gqa(
        params, model.num_heads, model.head_dim, 1, allow_unfinetuned=True)
  want = _jax_row(jax_cfg, jax_params, jax_examples, name, overrides, beams)
  got = quality_gates.gate_row(cfg, params, examples, name, overrides,
                               num_beams=beams, dtype='float32',
                               device='cpu')
  assert sorted(got) == sorted(want) and got['variant'] == name
  if name == 'bf16':
    assert want['onset_f1'] == 1.0, want
  for key in SCORES:
    if name in EXACT_ROWS:
      assert got[key] == want[key], (key, got, want)
    else:
      assert abs(got[key] - want[key]) <= QUANTIZED_TOL, (key, got, want)
  return got


def test_variants_are_the_jax_tools(jax_gates):
  assert quality_gates.VARIANTS == jax_gates.VARIANTS


@pytest.mark.parametrize('name', ['bf16', 'int8', 'int4_cross', 'int8dot'])
def test_gate_row_matches_jax(setup, jax_gates, name):
  check_row(setup, jax_gates, name)


def test_gate_row_tags_and_defaults_to_cuda(setup, monkeypatch):
  _, _, _, cfg, params, examples = setup
  row = quality_gates.gate_row(cfg, params, examples[:1], 'bf16', {},
                               dtype='float32', device='cpu', tag='ck_7')
  assert row['checkpoint'] == 'ck_7'
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    quality_gates.gate_row(cfg, params, examples[:1], 'bf16', {})
