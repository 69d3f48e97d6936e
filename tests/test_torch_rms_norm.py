"""Kernel D, T5's RMS norm (ops/rms_norm.py, csrc/rms_norm.cu).

On the CPU (tier 1):
* ops.rms_norm and layers.rms_norm on a CPU tensor equal the composition
  the port ran before the kernel, to the bit: forward and both gradients,
  in bf16 and float32, at widths 512 and 768 and 1, 7 and 1000 rows, and
  under torch.utils.checkpoint with the 'full' and 'dots' policies.
* layers.rms_norm counts norm.calls while the recorder is on, one a norm
  of a forward pass; the CPU path counts no norm.kernel_calls.
* The wrapper's route to the kernels, against a fake of the built library
  that computes the kernels' function in torch on the memory the pointers
  name: the arguments and dtype codes each entry point gets, the outputs
  and scratch it is given, rstd only where a gradient is needed, dscale
  only where the scale needs one, and the launch counts.
* The wrapper refuses what the kernel does not take, before any launch.

On the card (marked `card`, skipped without CUDA; run there with
`python -m pytest --noconftest tests/test_torch_rms_norm.py -m card`;
this file imports no JAX): the forward within one bf16 ulp of the plain
version (rstd within 1e-6 and, given it, the plain rounding steps to the
bit; float32 within 1e-6 relative), both gradients within the plain
version's own error against float64, the same gradients under both
checkpoint policies and from run to run, a CUDA-graph replay equal to an
eager call, the launch counts, and the wrapper's refusals.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import checkpoint as checkpoint_lib

from mt3_tpu_torch import ops
from mt3_tpu_torch.core import config as config_lib
from mt3_tpu_torch.models import layers, t5
from mt3_tpu_torch.ops import rms_norm as rms_norm_op
from mt3_tpu_torch.utils import profiling

torch.set_num_threads(2)

DTYPES = (torch.bfloat16, torch.float32)
EPS = 1e-6


@pytest.fixture(autouse=True)
def recorder():
  """Each test starts with the recorder off and empty, and leaves it so."""
  profiling.disable()
  profiling.reset()
  yield
  profiling.disable()
  profiling.reset()


def _composition(scale, x, epsilon=EPS, dtype=torch.float32):
  """layers.rms_norm as the port ran it before the kernel."""
  x = x.to(torch.float32)
  mean2 = torch.mean(x * x, dim=-1, keepdim=True)
  y = (x * torch.rsqrt(mean2 + epsilon)).to(dtype)
  return y * scale.to(dtype)


def _inputs(rows, width, dtype, device='cpu', seed=0):
  """x [rows, width] in dtype (the residual stream), the float32 scale
  and an upstream gradient in dtype, from numpy."""
  rng = np.random.RandomState(seed)
  x = torch.from_numpy(
      (rng.randn(rows, width) * 3 + rng.randn(rows, 1)).astype(np.float32))
  scale = torch.from_numpy((1 + 0.3 * rng.randn(width)).astype(np.float32))
  dy = torch.from_numpy(rng.randn(rows, width).astype(np.float32))
  return (scale.to(device).requires_grad_(),
          x.to(dtype).to(device).requires_grad_(), dy.to(dtype).to(device))


def _run(fn, scale, x, dy, dtype):
  y = fn(scale, x, EPS, dtype)
  dscale, dx = torch.autograd.grad(y, (scale, x), dy)
  return y, dx, dscale


# ---------------------------------------------------------------------------
# The CPU: the plain version is the composition.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('rows', [1, 7, 1000])
@pytest.mark.parametrize('width', [512, 768])
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_cpu_equals_the_composition_to_the_bit(dtype, width, rows):
  scale, x, dy = _inputs(rows, width, dtype)
  want = _run(_composition, scale, x, dy, dtype)
  for fn in (rms_norm_op.rms_norm, layers.rms_norm):
    got = _run(fn, scale, x, dy, dtype)
    for g, w in zip(got, want):
      assert g.dtype == w.dtype and torch.equal(g, w)
  assert want[0].dtype == dtype and want[1].dtype == dtype
  assert want[2].dtype == torch.float32


@pytest.mark.parametrize('policy', ['full', 'dots'])
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_cpu_under_checkpoint_equals_the_composition(dtype, policy):
  """A layer that norms and projects, through t5._maybe_remat."""
  scale, x, dy = _inputs(7, 512, dtype)
  kernel = torch.from_numpy(np.random.RandomState(1).randn(512, 512).astype(
      np.float32) / 20).requires_grad_()

  def layer(norm):
    return lambda x, scale, kernel: x + layers.dense(
        kernel, norm(scale, x, EPS, dtype), dtype)

  config = dataclasses.replace(config_lib.tiny_config().model, remat=True,
                               remat_policy=policy)
  results = []
  for fn in (t5._maybe_remat(layer(layers.rms_norm), config),
             layer(_composition)):
    y = fn(x, scale, kernel)
    results.append((y, *torch.autograd.grad(y, (x, scale, kernel), dy)))
  for g, w in zip(*results):
    assert torch.equal(g, w)


def _tiny():
  model = config_lib.tiny_config().model
  params = t5.init_params(model, torch.Generator().manual_seed(0))
  rng = np.random.RandomState(0)
  frames = torch.from_numpy(rng.randn(2, 8, model.input_depth).astype(
      np.float32))
  tokens = torch.from_numpy(rng.randint(1, model.vocab_size, (2, 16)))
  return model, params, frames, tokens


def test_norm_calls_count_each_norm_while_the_recorder_is_on():
  model, params, frames, tokens = _tiny()
  t5.forward(params, model, frames, tokens, tokens)
  assert profiling.collect()['counters'] == {}
  profiling.enable()
  t5.forward(params, model, frames, tokens, tokens)
  norms = (2 * model.num_encoder_layers + 1) + (
      3 * model.num_decoder_layers + 1)
  counters = profiling.collect()['counters']
  assert counters.get('norm.calls') == norms
  assert 'norm.kernel_calls' not in counters   # the CPU takes the plain path
  x = torch.ones(3, 8)
  layers.rms_norm(torch.ones(8), x)
  assert profiling.collect()['counters']['norm.calls'] == norms + 1


# ---------------------------------------------------------------------------
# The wrapper against a fake of the built library.
# ---------------------------------------------------------------------------
CODES = {0: torch.float32, 1: torch.bfloat16}
# csrc/rms_norm.cu: eight warps a block, one a row up to 1024 elements.
ROWS_PER_BLOCK = 8
FAKE_GRID = 3   # blocks that "fit on the card" in the fake


def _memory(ptr, count, dtype):
  """The count elements of dtype at address ptr, as a writable tensor."""
  nbytes = count * torch.tensor([], dtype=dtype).element_size()
  return torch.frombuffer((ctypes.c_byte * nbytes).from_address(ptr),
                          dtype=dtype)


class FakeLibrary:
  """csrc/rms_norm.cu's entry points, computed in torch on CPU memory:
  the kernels' function with their float32 arithmetic, and the backward's
  partial sums by block as its grid-stride loop assigns rows."""

  def __init__(self):
    self.calls = []

  def mt3_rms_norm_fwd(self, x, scale, y, rstd, rows, d, eps, dtype, stream):
    self.calls.append(('fwd', rstd is not None, rows, d, dtype))
    t = CODES[dtype]
    xs = _memory(x, rows * d, t).view(rows, d).float()
    s = _memory(scale, d, torch.float32)
    r = torch.rsqrt((xs * xs).sum(-1) / d + eps)
    n = (xs * r[:, None]).to(t).float()
    _memory(y, rows * d, t).copy_((n * s.to(t).float()).to(t).view(-1))
    if rstd is not None:
      _memory(rstd, rows, torch.float32).copy_(r)
    return 0

  def mt3_rms_norm_bwd_blocks(self, rows, d, dtype, blocks):
    blocks._obj.value = min(-(-rows // ROWS_PER_BLOCK), FAKE_GRID)
    return 0

  def mt3_rms_norm_bwd(self, x, dy, rstd, scale, dx, partial, dscale, rows, d,
                       blocks, dtype, stream):
    self.calls.append(('bwd', partial is not None, rows, d, dtype, blocks))
    t = CODES[dtype]
    xs = _memory(x, rows * d, t).view(rows, d).float()
    g = _memory(dy, rows * d, t).view(rows, d).float()
    r = _memory(rstd, rows, torch.float32)[:, None]
    s = _memory(scale, d, torch.float32).to(t).float()
    dot = (g * s * xs).sum(-1, keepdim=True)
    dxs = r * (g * s) - xs * (dot * r * r * r / d)
    _memory(dx, rows * d, t).copy_(dxs.to(t).view(-1))
    if partial is not None:
      parts = _memory(partial, blocks * d, torch.float32).view(blocks, d)
      block = (torch.arange(rows) // ROWS_PER_BLOCK) % blocks
      parts.zero_().index_add_(0, block, g * xs * r)
      _memory(dscale, d, torch.float32).copy_(parts.sum(0))
    return 0


@pytest.fixture
def fake(monkeypatch):
  lib = FakeLibrary()
  monkeypatch.setattr(rms_norm_op, '_library', lambda: lib)
  monkeypatch.setattr(rms_norm_op, '_stream', lambda t: None)
  ops.reset_launches()
  yield lib
  ops.reset_launches()


def _float64_grads(scale, x, dy, dtype):
  """The gradients of x * rstd * to_dtype(scale) in float64."""
  s = scale.detach().to(dtype).double().requires_grad_()
  xd = x.detach().double().requires_grad_()
  y = xd * torch.rsqrt((xd * xd).mean(-1, keepdim=True) + EPS) * s
  return torch.autograd.grad(y, (s, xd), dy.double())


@pytest.mark.parametrize('width', [64, 512, 768])
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_wrapper_route_with_a_fake_library(fake, dtype, width):
  scale, x, dy = _inputs(37, width, dtype)
  y = rms_norm_op._RMSNorm.apply(scale, x, EPS)
  dscale, dx = torch.autograd.grad(y, (scale, x), dy)
  code = rms_norm_op.DTYPES[dtype]
  assert fake.calls == [('fwd', True, 37, width, code),
                        ('bwd', True, 37, width, code, FAKE_GRID)]
  counts = ops.launch_counts()
  assert (counts['rms_norm_fwd'], counts['rms_norm_bwd']) == (1, 1)
  assert (y.dtype, dx.dtype, dscale.dtype) == (dtype, dtype, torch.float32)
  # The forward: within one rounding of the plain one.
  want = _composition(scale, x, EPS, dtype).detach().float()
  ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
  assert ((y.detach().float() - want).abs() <= ulp * want.abs()).all()
  # The gradients: the kernels' float32 formula against float64.
  ws, wx = _float64_grads(scale, x, dy, dtype)
  rel = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
  assert (dx.double() - wx).abs().max() <= rel * wx.abs().max()
  assert (dscale.double() - ws).abs().max() <= 1e-5 * ws.abs().max()


def test_wrapper_needs_no_rstd_without_a_gradient(fake):
  scale, x, dy = _inputs(5, 64, torch.bfloat16)
  with torch.no_grad():
    y, rstd = rms_norm_op._launch_fwd(scale, x, EPS, with_rstd=False)
  assert rstd is None and y.dtype == torch.bfloat16
  # Only the scale needs a gradient: no dscale scratch otherwise.
  y = rms_norm_op._RMSNorm.apply(scale.detach(), x, EPS)
  (dx,) = torch.autograd.grad(y, (x,), dy)
  assert dx.dtype == torch.bfloat16
  assert [c[:2] for c in fake.calls] == [('fwd', False), ('fwd', True),
                                         ('bwd', False)]


def test_wrapper_raises_off_cpu_and_cuda():
  """A meta tensor (neither CPU nor CUDA) goes to the kernel, which
  refuses it; nothing falls back to the plain version."""
  x = torch.empty(4, 512, device='meta')
  with pytest.raises(ValueError, match='CUDA'):
    rms_norm_op.rms_norm(torch.empty(512, device='meta'), x)


@pytest.mark.parametrize('case', ['non_contiguous', 'float16', 'width_12',
                                  'width_1032', 'width_8200', 'scale_shape',
                                  'empty', 'other_dtype', 'bf16_scale'])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, monkeypatch):
  """Checked before any launch (the CUDA check is faked: no card here)."""
  monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda self: True))
  meta = dict(device='meta')
  x, scale, dtype = torch.empty(4, 512, **meta), torch.empty(512, **meta), (
      torch.float32)
  if case == 'non_contiguous':
    x = torch.empty(512, 4, **meta).t()
  elif case.startswith('width'):
    width = int(case.split('_')[1])
    x, scale = torch.empty(4, width, **meta), torch.empty(width, **meta)
  elif case == 'scale_shape':
    scale = torch.empty(1, 512, **meta)
  elif case == 'other_dtype':
    dtype = torch.float32
  elif case == 'bf16_scale':
    scale = scale.bfloat16()
  else:
    x = torch.empty(0, 512, **meta)
  if case in ('float16', 'other_dtype'):
    x = x.to(torch.float16 if case == 'float16' else torch.bfloat16)
  match = {'non_contiguous': 'contiguous', 'float16': 'float32 or bfloat16',
           'other_dtype': 'in its dtype', 'scale_shape': 'scale',
           'bf16_scale': 'float32 scale'}.get(case, 'rows')
  with pytest.raises(ValueError, match=match):
    rms_norm_op.rms_norm(scale, x, EPS, dtype)


# ---------------------------------------------------------------------------
# The card.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda', 0)


def _card_inputs(card, rows, width, dtype, seed=0):
  return _inputs(rows, width, dtype, card, seed)


@pytest.mark.card
@pytest.mark.parametrize('rows', [1, 7, 1000, 3072])
@pytest.mark.parametrize('width', [8, 64, 256, 264, 512, 768, 1024])
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_card_forward_within_one_ulp_of_the_plain_version(card, dtype, width,
                                                          rows):
  """rstd within 1e-6 of the plain version's; given the kernel's rstd, y
  the plain version's rounding steps to the bit.  rstd's last bit (another
  sum order) moves n = to_dtype(x * rstd) by one bf16 ulp where x * rstd
  lies near a rounding boundary, so a bf16 y differs from the plain
  version's in a few elements; a float32 y within 1e-6 relative."""
  scale, x, _ = _card_inputs(card, rows, width, dtype)
  scale, x = scale.detach(), x.detach()
  xf = x.float()
  plain_rstd = torch.rsqrt((xf * xf).mean(-1) + EPS)
  y, rstd = rms_norm_op._launch_fwd(scale, x, EPS, with_rstd=True)
  assert ((rstd - plain_rstd).abs() <= 1e-6 * plain_rstd).all()
  steps = ((xf * rstd[:, None]).to(dtype).float()
           * scale.to(dtype).float()).to(dtype)
  assert torch.equal(y, steps)
  assert torch.equal(y, rms_norm_op.rms_norm(scale, x, EPS, dtype))
  want = rms_norm_op.rms_norm_plain(scale, x, EPS, dtype)
  if dtype == torch.bfloat16:
    assert (y != want).float().mean().item() <= 1e-3
  else:
    assert ((y - want).abs() <= 1e-6 * want.abs()).all()


@pytest.mark.card
@pytest.mark.parametrize('width', [512, 768])
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_card_gradients_within_the_plain_error_against_float64(card, dtype,
                                                               width):
  """Each gradient's largest error against float64 at most the plain
  version's own, or, where both round in float32, a few float32 ulps of
  the gradient's scale (the two sum in different orders)."""
  scale, x, dy = _card_inputs(card, 4096, width, dtype)
  kernel = _run(rms_norm_op.rms_norm, scale, x, dy, dtype)
  plain = _run(rms_norm_op.rms_norm_plain, scale, x, dy, dtype)
  ws, wx = _float64_grads(scale, x, dy, dtype)
  for got, base, want in ((kernel[1], plain[1], wx), (kernel[2], plain[2],
                                                      ws)):
    err = (got.double() - want).abs().max().item()
    plain_err = (base.double() - want).abs().max().item()
    floor = 4 * torch.finfo(torch.float32).eps * want.abs().max().item()
    assert err <= max(plain_err, floor), (err, plain_err, floor)


@pytest.mark.card
@pytest.mark.parametrize('policy', ['full', 'dots'])
def test_card_checkpoint_and_repeats_give_the_same_gradients(card, policy):
  scale, x, dy = _card_inputs(card, 2048, 512, torch.bfloat16)
  want = _run(rms_norm_op.rms_norm, scale, x, dy, torch.bfloat16)
  again = _run(rms_norm_op.rms_norm, scale, x, dy, torch.bfloat16)
  for g, w in zip(again, want):
    assert torch.equal(g, w)   # dscale's sum has a fixed order
  context_fn = (checkpoint_lib.noop_context_fn if policy == 'full' else
                lambda: checkpoint_lib.create_selective_checkpoint_contexts(
                    t5._save_matmuls))
  before = ops.launch_counts()
  y = checkpoint_lib.checkpoint(rms_norm_op.rms_norm, scale, x, EPS,
                                torch.bfloat16, use_reentrant=False,
                                context_fn=context_fn)
  dscale, dx = torch.autograd.grad(y, (scale, x), dy)
  for g, w in zip((y, dx, dscale), want):
    assert torch.equal(g, w)
  # The forward once, again in the recomputation, and the backward.
  after = ops.launch_counts()
  assert after['rms_norm_fwd'] - before['rms_norm_fwd'] == 2
  assert after['rms_norm_bwd'] - before['rms_norm_bwd'] == 1


@pytest.mark.card
def test_card_graph_replay_equals_an_eager_call(card):
  scale, x, _ = _card_inputs(card, 3072, 512, torch.bfloat16)
  x = x.detach()
  static = x.clone()
  rms_norm_op.rms_norm(scale, static, EPS, torch.bfloat16)   # loads the kernel
  stream = torch.cuda.Stream(card)
  stream.wait_stream(torch.cuda.current_stream(card))
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.stream(stream), torch.no_grad():
    graph.capture_begin()
    out = rms_norm_op.rms_norm(scale, static, EPS, torch.bfloat16)
    graph.capture_end()
  torch.cuda.current_stream(card).wait_stream(stream)
  for seed in (1, 2):
    fresh = _card_inputs(card, 3072, 512, torch.bfloat16, seed)[1].detach()
    static.copy_(fresh)
    graph.replay()
    with torch.no_grad():
      want = rms_norm_op.rms_norm(scale, fresh, EPS, torch.bfloat16)
    assert torch.equal(out, want)


@pytest.mark.card
def test_card_launch_counts_and_the_kernel_counter(card):
  scale, x, dy = _card_inputs(card, 64, 512, torch.bfloat16)
  ops.reset_launches()
  profiling.enable()
  with torch.no_grad():
    layers.rms_norm(scale, x, dtype=torch.bfloat16)
  _run(layers.rms_norm, scale, x, dy, torch.bfloat16)
  torch.cuda.synchronize()
  # Kernel D's launches under their names, every other kernel's name at 0,
  # and all of them at 0 again after a reset.
  assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0),
                                 'rms_norm_fwd': 2, 'rms_norm_bwd': 1}
  ops.reset_launches()
  assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
  counters = profiling.collect()['counters']
  assert counters['norm.calls'] == counters['norm.kernel_calls'] == 2


@pytest.mark.card
@pytest.mark.parametrize('case', ['non_contiguous', 'misaligned', 'float16',
                                  'width_12', 'width_1032', 'other_dtype'])
def test_card_wrapper_raises(card, case):
  scale, x, _ = _card_inputs(card, 16, 512, torch.bfloat16)
  scale, x = scale.detach(), x.detach()
  if case == 'non_contiguous':
    x = x.t().contiguous().t()
  elif case == 'misaligned':
    x = x.reshape(-1)[1:1 + 15 * 512].view(15, 512)
  elif case == 'float16':
    x = x.half()
  elif case == 'width_12':
    x, scale = x[:, :12].contiguous(), scale[:12].contiguous()
  elif case == 'width_1032':
    scale, x, _ = _card_inputs(card, 16, 1032, torch.bfloat16)
    scale, x = scale.detach(), x.detach()
  with pytest.raises(ValueError):
    rms_norm_op.rms_norm(scale, x, EPS, torch.float32 if case == 'other_dtype'
                         else torch.bfloat16)
