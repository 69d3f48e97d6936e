"""The decode step as one CUDA graph (models/t5.decode_step).

On the CPU (tier 1):
* The routing rule: a graph on a CUDA device without a mesh; CPU steps
  and a mesh's steps stay eager, and count no capture and no replay.
* The step's contract on both paths: the returned state is the one given,
  its index reads one more than before, and the caches hold the new
  column, in every decode mode of ModelConfig.
* The graph path's bookkeeping, with the capture faked (a "graph" that
  runs the captured function again at each replay): eager first step,
  one capture on the second, replays after; the logits in one output
  buffer; fresh states capture anew; other parameters start over; greedy
  decodes and beam search equal to the eager step's.

On the card (marked `card`, skipped without CUDA; run there with
`python -m pytest --noconftest tests/test_torch_decode_graph.py -m card`,
where --noconftest leaves out tests/conftest.py's JAX setup): decode_tokens
and beam_search with the real graph against the eager step on the same
inputs, at ismir2021 and mt3 width, b=8, in every mode: tokens equal,
logits within float32 rounding, counters as above.  This file imports no
JAX, so that it runs on a machine without it.
"""

import dataclasses

import pytest
import torch

from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.infer import beam_search as bs
from mt3_tpu_torch.infer import decode
from mt3_tpu_torch.models import t5
from mt3_tpu_torch.parallel import partitioning
from mt3_tpu_torch.utils import profiling

torch.set_num_threads(2)

# Every decode mode of ModelConfig, as overrides of the model config.
MODES = {
    'float32': {},
    'bfloat16': dict(dtype='bfloat16'),
    'gqa': dict(dtype='bfloat16', num_kv_heads=2),
    'int8': dict(decode_kv_quantize=True),
    'int4': dict(dtype='bfloat16', decode_kv_quantize=True,
                 decode_kv_bits=4),
    'int8_gqa': dict(num_kv_heads=2, decode_kv_quantize=True),
    'int4_gqa_production': dict(
        dtype='bfloat16', num_kv_heads=1, decode_kv_quantize=True,
        decode_kv_bits=4, decode_cross_kv_quantize=True,
        decode_cache_carry='stacked'),
    'xla_int8dot': dict(decode_kv_quantize=True,
                        decode_attention_impl='xla_int8dot'),
    'xla_int8dot_gqa': dict(dtype='bfloat16', num_kv_heads=2,
                            decode_kv_quantize=True,
                            decode_attention_impl='xla_int8dot'),
    'cross_int8': dict(dtype='bfloat16', decode_cross_kv_quantize=True),
    'pallas_v3': dict(decode_attention_impl='pallas_v3'),
    'onehot': dict(decode_cache_update='onehot'),
}
COUNTERS = ('decode.model_steps', 'decode.graph_captures',
            'decode.graph_replays')


@pytest.fixture(autouse=True)
def recorder():
  profiling.reset()
  profiling.enable()
  yield
  profiling.disable()
  profiling.reset()


def _counters():
  got = profiling.collect()['counters']
  return {name: got.get(name, 0) for name in COUNTERS}


def _model(preset, mode):
  base = {'tiny': torch_config.tiny_config,
          'mt3': torch_config.mt3_config,
          'ismir2021': torch_config.ismir2021_config}[preset]().model
  return dataclasses.replace(base, **MODES[mode])


def _setup(model, device, batch=2, frames=8, seed=0):
  params = params_lib.init_params(model, torch.Generator().manual_seed(seed))
  params = params_lib.to_device(params, device)
  gen = torch.Generator().manual_seed(seed + 1)
  inputs = torch.randn(batch, frames, model.input_depth, generator=gen)
  with torch.inference_mode():
    encoded = t5.encode(params, model, inputs.to(device))
  return params, encoded


def _eager(monkeypatch):
  monkeypatch.setattr(t5, '_graph_engages', lambda device, mesh: False)


class _FakeGraph:
  """Stands for a captured graph on the CPU: each replay runs the
  captured function again and writes its result into one output buffer."""

  def __init__(self, fn):
    self.fn = fn
    self.out = torch.empty(0)

  def replay(self):
    got = self.fn()
    self.out.resize_(got.shape).copy_(got)


def _fake_graph(monkeypatch):
  """The graph path on CPU tensors, with the capture faked."""
  def capture(fn, device):
    graph = _FakeGraph(fn)
    return graph, graph.out

  monkeypatch.setattr(t5, '_graph_engages', lambda device, mesh: mesh is None)
  monkeypatch.setattr(t5, '_capture', capture)


def _decode(params, model, encoded, steps, keep_logits=None):
  """Greedy decode_tokens; with keep_logits a list, each step's logits
  (copied) are appended to it."""
  step = t5.decode_step

  def keeping(*args, **kwargs):
    logits, state = step(*args, **kwargs)
    keep_logits.append(logits.clone())
    return logits, state

  with pytest.MonkeyPatch.context() as patch:
    if keep_logits is not None:
      patch.setattr(t5, 'decode_step', keeping)
    with torch.inference_mode():
      return decode.decode_tokens(params, model, encoded, steps,
                                  steps_per_iter=4)


# ---------------------------------------------------------------------------
# CPU: routing and the step's contract.
# ---------------------------------------------------------------------------
def test_the_graph_engages_on_a_cuda_device_without_a_mesh():
  mesh = partitioning.Mesh((1, 1), 0, 0, torch.device('cuda', 0),
                           {}, {})
  assert t5._graph_engages(torch.device('cuda', 0), None)
  assert not t5._graph_engages(torch.device('cuda', 0), mesh)
  assert not t5._graph_engages(torch.device('cpu'), None)


@pytest.mark.parametrize('on_mesh', [False, True])
def test_cpu_and_mesh_steps_stay_eager(on_mesh):
  model = _model('tiny', 'float32')
  params, encoded = _setup(model, 'cpu')
  mesh = None
  if on_mesh:
    groups = dict.fromkeys(('data', 'model', 'world'))
    mesh = partitioning.Mesh((1, 1), 0, 0, torch.device('cpu'), groups,
                             groups)
    params = partitioning.shard_params(params, params_lib.param_axes(model),
                                       mesh, model)
  with torch.inference_mode():
    state = t5.init_decode_state(params, model, encoded, 8, mesh=mesh)
    token = torch.zeros(2, dtype=torch.int32)
    for _ in range(3):
      _, state = t5.decode_step(params, model, token, state, mesh=mesh)
    tokens, _ = decode.decode_tokens(params, model, encoded, 8, mesh=mesh)
  assert state._graph is None
  assert tokens.shape == (2, 8)
  assert _counters() == {'decode.model_steps': 3 + 8,
                         'decode.graph_captures': 0,
                         'decode.graph_replays': 0}


@pytest.mark.parametrize('path', ['eager', 'graph'])
@pytest.mark.parametrize('mode', sorted(MODES))
def test_a_step_writes_its_column_and_advances_the_index(mode, path,
                                                         monkeypatch):
  """The returned state is the one given, its index one more than before
  the call, and the caches hold the new column and nothing past it."""
  if path == 'graph':
    _fake_graph(monkeypatch)
  model = _model('tiny', mode)
  params, encoded = _setup(model, 'cpu')
  with torch.inference_mode():
    state = t5.init_decode_state(params, model, encoded, 8)
    token = torch.tensor([3, 5], dtype=torch.int32)
    for step in range(4):
      logits, got = t5.decode_step(params, model, token, state)
      assert got is state and int(state.index) == step + 1
      assert logits.shape == (2, model.vocab_size)
      assert logits.dtype == torch.float32
      for cache in (state.cache.key, state.cache.value):
        assert cache[..., step].abs().sum() > 0, (mode, step)
        assert not cache[..., step + 1:].any(), (mode, step)
      token = logits.argmax(-1).to(torch.int32)


# ---------------------------------------------------------------------------
# CPU: the graph path's bookkeeping, with the capture faked.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('mode', sorted(MODES))
def test_a_faked_graph_decodes_as_the_eager_step(mode, monkeypatch):
  model = _model('tiny', mode)
  params, encoded = _setup(model, 'cpu')
  _eager(monkeypatch)
  want_logits = []
  want, want_lengths = _decode(params, model, encoded, 12, want_logits)
  profiling.reset()
  _fake_graph(monkeypatch)
  for call in range(2):   # two decodes, each with a fresh state
    got_logits = []
    got, got_lengths = _decode(params, model, encoded, 12, got_logits)
    assert torch.equal(got, want) and torch.equal(got_lengths, want_lengths)
    torch.testing.assert_close(torch.stack(got_logits),
                               torch.stack(want_logits), rtol=0, atol=0)
  assert _counters() == {'decode.model_steps': 24,
                         'decode.graph_captures': 2,
                         'decode.graph_replays': 22}


def test_replays_return_one_output_buffer_and_copy_the_token(monkeypatch):
  _fake_graph(monkeypatch)
  model = _model('tiny', 'float32')
  params, encoded = _setup(model, 'cpu')
  outs = []
  with torch.inference_mode():
    state = t5.init_decode_state(params, model, encoded, 8)
    for step in range(4):
      token = torch.full((2,), 7 + step, dtype=torch.int32)
      logits, state = t5.decode_step(params, model, token, state)
      outs.append(logits)
      if step:
        assert torch.equal(state._graph.token, token)
        assert state._graph.token is not token
  assert outs[0] is not outs[1]
  assert outs[1] is outs[2] is outs[3] is state._graph.logits
  assert int(state.index) == 4


def test_other_parameters_start_the_graph_over(monkeypatch):
  """A state's graph serves the parameters it was captured with: a step
  with others runs eagerly and the next captures again."""
  _fake_graph(monkeypatch)
  model = _model('tiny', 'float32')
  params, encoded = _setup(model, 'cpu')
  other = params_lib.init_params(model, torch.Generator().manual_seed(9))
  token = torch.zeros(2, dtype=torch.int32)
  with torch.inference_mode():
    state = t5.init_decode_state(params, model, encoded, 8)
    for p in (params, params, params, other, other, other):
      _, state = t5.decode_step(p, model, token, state)
  assert state._graph.params is other
  assert _counters() == {'decode.model_steps': 6,
                         'decode.graph_captures': 2,
                         'decode.graph_replays': 4}


def test_a_new_state_from_replace_starts_without_a_graph(monkeypatch):
  _fake_graph(monkeypatch)
  model = _model('tiny', 'float32')
  params, encoded = _setup(model, 'cpu')
  token = torch.zeros(2, dtype=torch.int32)
  with torch.inference_mode():
    state = t5.init_decode_state(params, model, encoded, 8)
    for _ in range(2):
      _, state = t5.decode_step(params, model, token, state)
    fresh = dataclasses.replace(state, index=state.index.clone())
  assert state._graph.graph is not None and fresh._graph is None


@pytest.mark.parametrize('mode', ['float32', 'int4_gqa_production'])
def test_a_faked_graph_beam_search_equals_the_eager_step(mode, monkeypatch):
  model = _model('tiny', mode)
  params, encoded = _setup(model, 'cpu')
  results = []
  for graphed in (False, True):
    (_fake_graph if graphed else _eager)(monkeypatch)
    with torch.inference_mode():
      results.append(bs.beam_search(params, model, encoded, 10, num_beams=3,
                                    steps_per_iter=2))
  (want_tokens, want_scores), (got_tokens, got_scores) = results
  assert torch.equal(got_tokens, want_tokens)
  torch.testing.assert_close(got_scores, want_scores, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The card: the real graph against the eager step.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda', 0)


CARD_STEPS = 48


@pytest.mark.card
@pytest.mark.parametrize('mode', sorted(MODES))
@pytest.mark.parametrize('preset', ['ismir2021', 'mt3'])
def test_card_graph_decode_equals_the_eager_step(card, preset, mode,
                                                 monkeypatch):
  model = _model(preset, mode)
  params, encoded = _setup(model, card, batch=8, frames=64)
  with monkeypatch.context() as patch:
    _eager(patch)
    want_logits = []
    want, _ = _decode(params, model, encoded, CARD_STEPS, want_logits)
  profiling.reset()
  for _ in range(2):   # two decodes, each with a fresh state
    got_logits = []
    got, _ = _decode(params, model, encoded, CARD_STEPS, got_logits)
    assert torch.equal(got, want)
    torch.testing.assert_close(torch.stack(got_logits),
                               torch.stack(want_logits))
  assert _counters() == {'decode.model_steps': 2 * CARD_STEPS,
                         'decode.graph_captures': 2,
                         'decode.graph_replays': 2 * (CARD_STEPS - 1)}


@pytest.mark.card
@pytest.mark.parametrize('mode', ['bfloat16', 'int4_gqa_production'])
def test_card_graph_beam_search_equals_the_eager_step(card, mode,
                                                      monkeypatch):
  model = _model('mt3', mode)
  params, encoded = _setup(model, card, batch=8, frames=64)
  results = []
  for graphed in (False, True):
    with monkeypatch.context() as patch:
      if not graphed:
        _eager(patch)
      with torch.inference_mode():
        results.append(bs.beam_search(params, model, encoded, CARD_STEPS,
                                      num_beams=4, steps_per_iter=8))
  (want_tokens, want_scores), (got_tokens, got_scores) = results
  assert torch.equal(got_tokens, want_tokens)
  torch.testing.assert_close(got_scores, want_scores)
  assert _counters()['decode.graph_captures'] == 1
