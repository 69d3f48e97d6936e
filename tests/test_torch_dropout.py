"""Kernel E, dropout and its residual add (ops/dropout.py,
csrc/dropout_add.cu), and t5._dropout, the one helper that calls it.

On the CPU (tier 1):
* ops.dropout.dropout_add_plain, ops.dropout.dropout_add and t5._dropout
  on a CPU tensor equal the composition the port ran before the kernel
  (t5._dropout, then the add), to the bit: forward and gradients, in bf16
  and float32, with the mask broadcast along the length and full, with
  and without a residual; so do a whole model's loss and gradients, also
  under torch.utils.checkpoint.
* Without a generator, or at rate 0, t5._dropout returns x (or
  residual + x) and calls no dropout op.
* t5._dropout counts dropout.calls while the recorder is on, one a live
  site (recomputed sites again under remat); the CPU path counts no
  dropout.kernel_calls.  Every site hands the op h and its residual in
  one dtype and shape.
* The wrapper's route to the kernel, against a fake of the built library
  that computes the kernel's function in torch on the memory the pointers
  name, with the kernel's own mask addressing: the arguments, the rounding
  of the card's plain version, the residual's gradient passed on as dy
  itself, only the mask saved, and the launch counts.
* The wrapper refuses what the kernel does not take, before any launch.

On the card (marked `card`, skipped without CUDA; run there with
`python -m pytest --noconftest tests/test_torch_dropout.py -m card`; this
file imports no JAX): the kernel bit-identical to the plain version on
the same CUDA tensors, forward and backward, in both dtypes, broadcast and
full masks, with and without a residual, at widths that take 16-byte
pieces and at widths and offsets that take one element a lane; launch
counts and counters through t5._dropout under checkpoint.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import checkpoint as checkpoint_lib

from mt3_tpu_torch import ops
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as config_lib
from mt3_tpu_torch.models import layers, t5
from mt3_tpu_torch.ops import dropout as dropout_op
from mt3_tpu_torch.train import losses
from mt3_tpu_torch.utils import profiling

torch.set_num_threads(2)

DTYPES = (torch.bfloat16, torch.float32)
RATE = 0.1


@pytest.fixture(autouse=True)
def recorder():
  """Each test starts with the recorder off and empty, and leaves it so."""
  profiling.disable()
  profiling.reset()
  yield
  profiling.disable()
  profiling.reset()


def _old_dropout(generator, x, rate, broadcast_length=True, mesh=None,
                 model_dim=None, residual=None):
  """t5._dropout and the add after it as the port ran them before kernel
  E."""
  if generator is not None and rate != 0.0:
    shape = list(x.shape)
    if broadcast_length and len(shape) >= 2:
      shape[-2] = 1
    keep = layers.dropout_keep(generator, shape, rate, x.device, mesh,
                               model_dim)
    x = torch.where(keep, x / torch.tensor(1.0 - rate, dtype=x.dtype),
                    torch.zeros((), dtype=x.dtype, device=x.device))
  return x if residual is None else residual + x


def _inputs(shape, dtype, device='cpu', seed=0):
  """h and the residual x in dtype, needing gradients, and dy, from numpy."""
  rng = np.random.RandomState(seed)
  h, x, dy = (torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))
              .to(dtype).to(device) for s in (3.0, 1.0, 1.0))
  return h.requires_grad_(), x.requires_grad_(), dy


def _grads(y, h, x, dy):
  wrt = (h,) if x is None else (h, x)
  return torch.autograd.grad(y, wrt, dy)


# ---------------------------------------------------------------------------
# The CPU: the plain version is the old composition.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('residual', [True, False], ids=['residual', 'alone'])
@pytest.mark.parametrize('broadcast', [True, False], ids=['broadcast', 'full'])
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_cpu_equals_the_old_composition_to_the_bit(dtype, broadcast,
                                                   residual):
  h, x, dy = _inputs((3, 40, 24), dtype)
  x = x if residual else None
  want = _old_dropout(torch.Generator().manual_seed(5), h, RATE, broadcast,
                      residual=x)
  want_grads = _grads(want, h, x, dy)
  shape = (3, 1 if broadcast else 40, 24)
  keep = layers.dropout_keep(torch.Generator().manual_seed(5), shape, RATE,
                             'cpu')
  for got in (t5._dropout(torch.Generator().manual_seed(5), h, RATE,
                          broadcast, residual=x),
              dropout_op.dropout_add(h, keep, RATE, x),
              dropout_op.dropout_add_plain(h, keep, RATE, x)):
    assert got.dtype == dtype and torch.equal(got, want)
    for g, w in zip(_grads(got, h, x, dy), want_grads):
      assert g.dtype == dtype and torch.equal(g, w)
  assert keep.any() and not keep.all()   # dropout fired


def _tiny(dtype='float32', **model):
  model = dataclasses.replace(config_lib.tiny_config().model, dtype=dtype,
                              dropout_rate=RATE, **model)
  params = t5.init_params(model, torch.Generator().manual_seed(0))
  rng = np.random.RandomState(0)
  frames = torch.from_numpy(rng.randn(2, 8, model.input_depth).astype(
      np.float32))
  tokens = torch.from_numpy(rng.randint(1, model.vocab_size, (2, 16)))
  return model, params, frames, tokens


def _loss_and_grads(model, params, frames, tokens):
  leaves = [p.requires_grad_() for p in params_lib.tree_leaves(params)]
  logits = t5.forward(params, model, frames, tokens, tokens,
                      generator=torch.Generator().manual_seed(11))
  loss = losses.cross_entropy_with_z_loss(
      logits, tokens, torch.ones_like(tokens, dtype=torch.float32),
      z_loss=1e-4)[0]
  return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize('remat', [None, 'full', 'dots'])
def test_model_loss_and_gradients_equal_the_old_composition(remat,
                                                            monkeypatch):
  """A tiny model in bf16 with dropout live: the same loss and every
  gradient to the bit as with the old t5._dropout."""
  extra = dict(remat=True, remat_policy=remat) if remat else {}
  model, params, frames, tokens = _tiny('bfloat16', **extra)
  got = _loss_and_grads(model, params, frames, tokens)
  monkeypatch.setattr(t5, '_dropout', _old_dropout)
  want = _loss_and_grads(model, params, frames, tokens)
  assert torch.equal(got[0], want[0])
  assert len(got[1]) == len(want[1]) > 0
  for g, w in zip(*(r[1] for r in (got, want))):
    assert torch.equal(g, w)


@pytest.mark.parametrize('residual', [True, False], ids=['residual', 'alone'])
@pytest.mark.parametrize('off', ['no_generator', 'rate_0'])
def test_dropout_off_takes_the_old_path_untouched(off, residual,
                                                  monkeypatch):
  def refuse(*args, **kwargs):
    raise AssertionError('no dropout op runs with dropout off')

  monkeypatch.setattr(dropout_op, 'dropout_add', refuse)
  profiling.enable()
  h, x, _ = _inputs((2, 5, 8), torch.bfloat16)
  gen = None if off == 'no_generator' else torch.Generator().manual_seed(0)
  rate = RATE if off == 'no_generator' else 0.0
  if residual:
    assert torch.equal(t5._dropout(gen, h, rate, residual=x), x + h)
  else:
    assert t5._dropout(gen, h, rate) is h
  assert profiling.collect()['counters'] == {}


def _sites(model):
  """Live dropout sites of a forward pass: an encoder layer's two
  residual adds and MLP, a decoder layer's three and MLP, and each
  stack's input and output."""
  return (3 * model.num_encoder_layers + 2) + (4 * model.num_decoder_layers
                                               + 2)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_dropout_calls_count_every_live_site(dtype, monkeypatch):
  model, params, frames, tokens = _tiny(dtype)
  seen = []
  plain = dropout_op.dropout_add

  def recording(h, keep, rate, residual=None):
    seen.append((h.dtype, tuple(h.shape), tuple(keep.shape),
                 None if residual is None else
                 (residual.dtype, tuple(residual.shape))))
    return plain(h, keep, rate, residual)

  monkeypatch.setattr(dropout_op, 'dropout_add', recording)
  t5.forward(params, model, frames, tokens, tokens,
             generator=torch.Generator().manual_seed(1))
  assert profiling.collect()['counters'] == {}   # the recorder is off
  profiling.enable()
  t5.forward(params, model, frames, tokens, tokens,
             generator=torch.Generator().manual_seed(1))
  counters = profiling.collect()['counters']
  assert counters.get('dropout.calls') == _sites(model)
  assert 'dropout.kernel_calls' not in counters   # the CPU's plain path
  assert len(seen) == 2 * _sites(model)
  want = {torch.float32: torch.float32,
          torch.bfloat16: torch.bfloat16}[t5._dtype(model)]
  residuals = 0
  for h_dtype, h_shape, keep_shape, res in seen:
    assert h_dtype == want, seen
    assert keep_shape in (h_shape, h_shape[:-2] + (1,) + h_shape[-1:])
    if res is not None:
      residuals += 1
      assert res == (h_dtype, h_shape), seen
  assert residuals == 2 * (2 * model.num_encoder_layers
                           + 3 * model.num_decoder_layers)
  # The encoder's output alone takes a full mask.
  assert sum(k == h for _, h, k, _ in seen) == 2


def test_remat_counts_the_recomputed_sites_again():
  model, params, frames, tokens = _tiny(remat=True, remat_policy='full')
  profiling.enable()
  _loss_and_grads(model, params, frames, tokens)
  layer_sites = 3 * model.num_encoder_layers + 4 * model.num_decoder_layers
  counters = profiling.collect()['counters']
  assert counters['dropout.calls'] == _sites(model) + layer_sites


# ---------------------------------------------------------------------------
# The wrapper against a fake of the built library.
# ---------------------------------------------------------------------------
CODES = {0: torch.float32, 1: torch.bfloat16}


def _memory(ptr, count, dtype):
  """The count elements of dtype at address ptr, as a writable tensor."""
  nbytes = count * torch.tensor([], dtype=dtype).element_size()
  return torch.frombuffer((ctypes.c_byte * nbytes).from_address(ptr),
                          dtype=dtype)


class FakeLibrary:
  """csrc/dropout_add.cu's entry point, computed in torch on CPU memory:
  the kernel's float32 arithmetic, and element e's mask byte read where the
  kernel reads it, at (e // (length * d)) * d + e % d."""

  def __init__(self):
    self.calls = []

  def mt3_dropout_add(self, x, h, keep, y, n, d, length, inv, dtype, stream):
    self.calls.append((x is not None, n, d, length, inv, dtype))
    t = CODES[dtype]
    e = torch.arange(n)
    kept = _memory(keep, n // length, torch.bool)[
        e // (length * d) * d + e % d]
    out = torch.where(kept, (_memory(h, n, t).float() * inv).to(t).float(),
                      torch.zeros(()))
    if x is not None:
      out = _memory(x, n, t).float() + out
    _memory(y, n, t).copy_(out.to(t))
    return 0


@pytest.fixture
def fake(monkeypatch):
  lib = FakeLibrary()
  monkeypatch.setattr(dropout_op, '_library', lambda: lib)
  monkeypatch.setattr(dropout_op, '_stream', lambda t: None)
  ops.reset_launches()
  yield lib
  ops.reset_launches()


def _card_plain(h, keep, rate, residual=None):
  """dropout_add_plain as PyTorch computes it on a CUDA tensor: the
  division by a CPU scalar as a product with its float32 reciprocal."""
  inv = dropout_op._inverse_keep(rate, h.dtype)
  out = torch.where(keep, (h.float() * inv).to(h.dtype),
                    torch.zeros((), dtype=h.dtype))
  return out if residual is None else residual + out


@pytest.mark.parametrize('residual', [True, False], ids=['residual', 'alone'])
@pytest.mark.parametrize('broadcast', [True, False], ids=['broadcast', 'full'])
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_wrapper_route_with_a_fake_library(fake, dtype, broadcast, residual):
  h, x, dy = _inputs((3, 10, 16), dtype)
  x = x if residual else None
  keep = layers.dropout_keep(torch.Generator().manual_seed(2),
                             (3, 1 if broadcast else 10, 16), RATE, 'cpu')
  inv = dropout_op._inverse_keep(RATE, dtype)
  y = dropout_op._DropoutAdd.apply(h, keep, inv, x)
  saved = y.grad_fn.saved_tensors   # the mask alone
  assert len(saved) == 1 and saved[0].data_ptr() == keep.data_ptr()
  grads = _grads(y, h, x, dy)
  code = dropout_op.DTYPES[dtype]
  length = 10 if broadcast else 1
  assert fake.calls == [(residual, 480, 16, length, inv, code),
                        (False, 480, 16, length, inv, code)]
  counts = ops.launch_counts()
  assert (counts['dropout_add_fwd'], counts['dropout_add_bwd']) == (1, 1)
  assert y.dtype == dtype and torch.equal(y, _card_plain(h, keep, RATE, x))
  assert torch.equal(grads[0], _card_plain(dy, keep, RATE))
  if residual:
    # The residual's gradient is dy itself: no kernel, no copy.
    assert grads[1].data_ptr() == dy.data_ptr()
  # Bit for bit the old composition, which divides the same way in bf16.
  if dtype == torch.bfloat16:
    assert torch.equal(y, dropout_op.dropout_add_plain(h, keep, RATE, x))


def test_wrapper_launches_under_checkpoint_and_without_grad(fake):
  h, x, dy = _inputs((2, 8, 8), torch.float32)
  keep = layers.dropout_keep(torch.Generator().manual_seed(3), (2, 1, 8),
                             RATE, 'cpu')
  inv = dropout_op._inverse_keep(RATE, torch.float32)
  with torch.no_grad():
    y = dropout_op._launch(h, keep, inv, x, 'dropout_add_fwd')
  assert y.grad_fn is None

  def apply(h, x):
    return dropout_op._DropoutAdd.apply(h, keep, inv, x)

  z = checkpoint_lib.checkpoint(apply, h, x, use_reentrant=False)
  _grads(z, h, x, dy)
  assert torch.equal(y, z)
  counts = ops.launch_counts()
  # The no-grad call, the forward, its recomputation and the backward.
  assert (counts['dropout_add_fwd'], counts['dropout_add_bwd']) == (3, 1)


def test_wrapper_raises_off_cpu_and_cuda():
  """A meta tensor (neither CPU nor CUDA) goes to the kernel, which
  refuses it; nothing falls back to the plain version."""
  h = torch.empty(2, 4, 8, device='meta')
  with pytest.raises(ValueError, match='CUDA'):
    dropout_op.dropout_add(h, torch.empty(2, 1, 8, dtype=torch.bool,
                                          device='meta'), RATE)


@pytest.mark.parametrize('case', [
    'float16', 'mask_dtype', 'mask_shape', 'mask_length', 'mask_device',
    'residual_dtype', 'residual_shape', 'non_contiguous',
    'residual_non_contiguous', 'empty'])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, monkeypatch):
  """Checked before any launch (the CUDA check is faked: no card here)."""
  monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda self: True))
  meta = dict(device='meta')
  h = torch.empty(2, 4, 8, **meta)
  keep = torch.empty(2, 1, 8, dtype=torch.bool, **meta)
  residual = None
  if case == 'float16':
    h = h.half()
  elif case == 'mask_dtype':
    keep = keep.float()
  elif case == 'mask_shape':
    keep = torch.empty(2, 1, 4, dtype=torch.bool, **meta)
  elif case == 'mask_length':
    keep = torch.empty(2, 2, 8, dtype=torch.bool, **meta)
  elif case == 'mask_device':
    keep = torch.empty(2, 1, 8, dtype=torch.bool)
  elif case == 'residual_dtype':
    residual = torch.empty(2, 4, 8, dtype=torch.bfloat16, **meta)
  elif case == 'residual_shape':
    residual = torch.empty(2, 1, 8, **meta)
  elif case == 'non_contiguous':
    h = torch.empty(2, 8, 4, **meta).transpose(1, 2)
  elif case == 'residual_non_contiguous':
    residual = torch.empty(2, 8, 4, **meta).transpose(1, 2)
  else:
    h, keep = torch.empty(0, 4, 8, **meta), torch.empty(
        0, 1, 8, dtype=torch.bool, **meta)
  match = {'float16': 'float32 or bfloat16', 'mask_dtype': 'bool mask',
           'mask_device': 'bool mask', 'mask_shape': 'mask of',
           'mask_length': 'mask of', 'residual_dtype': 'residual',
           'residual_shape': 'residual', 'non_contiguous': 'h contiguous',
           'residual_non_contiguous': 'residual contiguous',
           'empty': 'elements'}[case]
  ops.reset_launches()
  with pytest.raises(ValueError, match=match):
    dropout_op.dropout_add(h, keep, RATE, residual)
  assert not any(ops.launch_counts().values())


# ---------------------------------------------------------------------------
# The card.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda', 0)


@pytest.mark.card
@pytest.mark.parametrize('residual', [True, False], ids=['residual', 'alone'])
@pytest.mark.parametrize('broadcast', [True, False], ids=['broadcast', 'full'])
@pytest.mark.parametrize('shape', [(4, 64, 512), (2, 7, 1024), (3, 5, 12),
                                   (2, 3, 1), (5, 8)], ids=str)
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_card_equals_the_plain_version_to_the_bit(card, dtype, shape,
                                                  broadcast, residual):
  """Widths of a multiple of 8 take 16-byte pieces, 12 and 1 one element
  a lane."""
  h, x, dy = _inputs(shape, dtype, card, seed=sum(shape))
  x = x if residual else None
  mask_shape = shape[:-2] + (1,) + shape[-1:] if broadcast else shape
  keep = layers.dropout_keep(torch.Generator(card).manual_seed(4),
                             mask_shape, RATE, card)
  want = dropout_op.dropout_add_plain(h, keep, RATE, x)
  got = dropout_op.dropout_add(h, keep, RATE, x)
  assert got.dtype == dtype and torch.equal(got, want)
  for g, w in zip(_grads(got, h, x, dy), _grads(want, h, x, dy)):
    assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_card_unaligned_and_sliced_tensors(card, dtype):
  """A view one element in takes the kernel one element a lane; a sliced
  mask (a mesh rank's block) is made contiguous first."""
  h, x, _ = _inputs((4, 16, 64), dtype, card)
  h, x = (t.detach().reshape(-1)[1:1 + 3 * 16 * 64].view(3, 16, 64)
          for t in (h, x))
  keep = layers.dropout_keep(torch.Generator(card).manual_seed(6),
                             (6, 1, 128), RATE, card)[:3, :, 64:]
  assert not keep.is_contiguous()
  want = dropout_op.dropout_add_plain(h, keep, RATE, x)
  assert torch.equal(dropout_op.dropout_add(h, keep, RATE, x), want)


@pytest.mark.card
def test_card_counters_and_launches_under_checkpoint(card):
  h, x, dy = _inputs((8, 32, 512), torch.bfloat16, card)
  ops.reset_launches()
  profiling.enable()

  def site(h, x):
    return t5._dropout(torch.Generator(card).manual_seed(9), h, RATE,
                       residual=x)

  y = checkpoint_lib.checkpoint(site, h, x, use_reentrant=False)
  got = _grads(y, h, x, dy)
  want = _old_dropout(torch.Generator(card).manual_seed(9), h, RATE,
                      residual=x)
  assert torch.equal(y, want)
  for g, w in zip(got, _grads(want, h, x, dy)):
    assert torch.equal(g, w)
  torch.cuda.synchronize()
  assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0),
                                 'dropout_add_fwd': 2, 'dropout_add_bwd': 1}
  counters = profiling.collect()['counters']
  assert counters['dropout.calls'] == counters['dropout.kernel_calls'] == 2
