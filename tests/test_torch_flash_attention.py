"""Kernel C's plain version against the stock TPU flash-attention kernel.

mt3_tpu_torch.ops.flash_attention.flash_attention_plain (what the port runs
on a CPU tensor, and what chip_smoke.py holds the CUDA kernels against) and
its autograd backward are compared with
jax.experimental.pallas.ops.tpu.flash_attention.flash_attention, run in
interpret mode with the block sizes mt3_tpu/models/layers.py gives it, on
the same numpy inputs.  Causal and full, (lq, lk) in {(128, 128),
(256, 128)}, head dims 8 and 64; float32 here, bfloat16 in
test_torch_flash_attention_bf16.py (split to keep each file short).

Tolerances, for each of o, dq, dk and dv:
  * float32: 2e-5 * (1 + |x|) elementwise.  Both sides sum 128-256
    float32 products (o, dk, dv within 2e-6).  dq of a causal row's first
    keys is p * (dP - di) with dP and di nearly equal: the stock kernel
    forms di with XLA and dP in the kernel, in two sum orders, and leaves
    up to 1.2e-5 where autograd's softmax backward gives ~0.
  * bfloat16 inputs: relative error ||g - w||_2 / ||w||_2 <= 1e-2 in
    every 64-row block of every (batch, head), of the plain version
    against the stock kernel, and against the float32 truth (the plain
    version in float32 on the same bf16-rounded inputs).  Both sides
    round p or dP, dS and the outputs to bfloat16 (2**-9 relative), in
    different places, and measure 2-5e-3.  No elementwise limit: dq is a
    cancelling sum whose rounding follows the size of its terms, not its
    own, and the stock kernel itself is 4.5e-2 * (1 + |w|) off the truth
    in causal first rows.

The wrapper's route to the kernels (which entry points run for which
dtype, with which strides, and that PyTorch copies and computes nothing on
the way) is checked against a fake of the built library: there is no card
here, and the kernels themselves are checked on one by chip_smoke.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax.experimental.pallas.tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as stock
from torch.utils._python_dispatch import TorchDispatchMode

from mt3_tpu_torch import ops
from mt3_tpu_torch.ops import cuda_build, flash_attention

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_TOL = 1e-2
CASES = list(itertools.product(((128, 128), (256, 128)), (True, False),
                               (8, 64)))


def _block_sizes(lq, lk):
  """As mt3_tpu/models/layers.py:232-238."""
  bq, bk = min(512, lq), min(512, lk)
  return stock.BlockSizes(
      block_q=bq, block_k_major=bk, block_k=bk, block_b=1,
      block_q_major_dkv=bq, block_k_major_dkv=bk, block_k_dkv=bk,
      block_q_dkv=bq, block_k_major_dq=bk, block_k_dq=bk, block_q_dq=bq)


def _inputs(lq, lk, d, seed):
  rng = np.random.RandomState(seed)
  b, h = 2, 2
  # Scores of unit variance, as the 1/sqrt(d)-scaled query init gives.
  q = rng.randn(b, h, lq, d).astype(np.float32) / np.sqrt(d)
  k = rng.randn(b, h, lk, d).astype(np.float32)
  v = rng.randn(b, h, lk, d).astype(np.float32)
  do = rng.randn(b, h, lq, d).astype(np.float32) / 2
  return q, k, v, do


def _stock(q, k, v, do, causal, dtype):
  lq, lk = q.shape[2], k.shape[2]
  args = [jnp.asarray(x, dtype) for x in (q, k, v)]
  with pltpu.force_tpu_interpret_mode():
    o, vjp = jax.vjp(
        lambda q, k, v: stock.flash_attention(
            q, k, v, causal=causal, sm_scale=1.0,
            block_sizes=_block_sizes(lq, lk)), *args)
    grads = vjp(jnp.asarray(do, dtype))
  return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def tile_rel_err(got, want, tile=64):
  """Largest ||got - want||_2 / ||want||_2 over the `tile`-row blocks of
  each (batch, head) of [b, h, len, d] arrays."""
  b, h, length, d = want.shape
  shape = (b, h, length // tile, tile * d)
  diff = np.linalg.norm((got - want).reshape(shape), axis=-1)
  return (diff / np.linalg.norm(want.reshape(shape), axis=-1)).max()


def _plain(q, k, v, do, causal, dtype):
  args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
  o = flash_attention.flash_attention(*args, causal=causal, sm_scale=1.0)
  grads = torch.autograd.grad(o, args, torch.from_numpy(do).to(dtype))
  return [x.detach().float().numpy() for x in (o, *grads)]


@pytest.mark.parametrize('lengths,causal,head_dim', CASES)
def test_plain_matches_stock_kernel_float32(lengths, causal, head_dim):
  lq, lk = lengths
  inputs = _inputs(lq, lk, head_dim, seed=lq + lk + head_dim + causal)
  want = _stock(*inputs, causal, jnp.float32)
  got = _plain(*inputs, causal, torch.float32)
  for name, g, w in zip(('o', 'dq', 'dk', 'dv'), got, want):
    excess = np.abs(g - w) - F32_TOL * (1 + np.abs(w))
    assert excess.max() <= 0, (name, np.abs(g - w).max())


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
  q, k, v, _ = _inputs(128, 128, 64, seed=3)
  args = [torch.from_numpy(x) for x in (q, k, v)]
  ops.reset_launches()
  got = flash_attention.flash_attention(*args, causal=True)
  want = flash_attention.flash_attention_plain(*args, causal=True)
  assert torch.equal(got, want)
  assert not any(ops.launch_counts().values())


def test_wrapper_raises_off_cpu_and_cuda():
  """A meta tensor (neither CPU nor CUDA) goes to the kernel, which
  refuses it; nothing falls back to the plain version."""
  q = torch.empty(1, 6, 128, 64, device='meta')
  with pytest.raises(ValueError, match='CUDA'):
    flash_attention.flash_attention(q, q, q, causal=False)


def test_wrapper_raises_on_unsupported_head_dim(monkeypatch):
  """Head dims other than 64 raise before any launch (the CUDA check is
  faked: there is no card here)."""
  q = torch.empty(1, 4, 128, 8, device='meta')
  monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda self: True))
  with pytest.raises(ValueError, match='head_dim 8'):
    flash_attention.flash_attention(q, q, q, causal=True)
  with pytest.raises(ValueError, match='float32 or bfloat16'):
    h = torch.empty(1, 4, 128, 64, device='meta', dtype=torch.float16)
    flash_attention.flash_attention(h, h, h, causal=True)
  assert flash_attention.HEAD_DIMS == (64,)


def test_plain_version_on_transposed_views_equals_contiguous_copies():
  """layers.attention passes [b, len, h, d] activations transposed; the
  plain version gives the same values and gradients as on copies."""
  rng = np.random.RandomState(5)
  views, copies = [], []
  for length, scale in ((192, 0.125), (128, 1.0), (128, 1.0)):
    x = torch.from_numpy(rng.randn(2, length, 3, 64).astype(np.float32))
    views.append((x * scale).transpose(1, 2).requires_grad_())
    copies.append(views[-1].detach().contiguous().requires_grad_())
  do = torch.from_numpy(rng.randn(2, 3, 192, 64).astype(np.float32))
  got = flash_attention.flash_attention_plain(*views, causal=True)
  want = flash_attention.flash_attention_plain(*copies, causal=True)
  assert not views[0].is_contiguous()
  assert torch.equal(got, want)
  for g, w in zip(torch.autograd.grad(got, views, do),
                  torch.autograd.grad(want, copies, do)):
    assert torch.equal(g, w)


class _FakeEntry:
  """A kernel entry point that records its FlashArgs and reports success."""

  def __init__(self, source, name, calls):
    self.source, self.name, self.calls = source, name, calls
    self.argtypes = self.restype = None

  def __call__(self, args, stream):
    a = args._obj   # the FlashArgs behind ctypes.byref
    strides = {f: tuple(getattr(getattr(a, f'{f}_st'), k)
                        for k in ('batch', 'head', 'row'))
               for f in ('q', 'k', 'v', 'o', 'dout', 'dq', 'dk', 'dv')}
    self.calls.append((self.source, self.name, strides,
                       (a.batch, a.heads, a.lq, a.lk, a.causal, a.sm_scale)))
    return 0


class _FakeLibrary:
  def __init__(self, source, calls):
    self.source, self.calls = source, calls

  def __getattr__(self, name):
    entry = _FakeEntry(self.source, name, self.calls)
    setattr(self, name, entry)
    return entry


class _RecordOps(TorchDispatchMode):
  def __init__(self):
    super().__init__()
    self.ops = []

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    self.ops.append(func.overloadpacket.__name__)
    return func(*args, **(kwargs or {}))


@pytest.fixture
def fake_kernels(monkeypatch):
  """Meta tensors pass for CUDA ones and the built libraries are fakes
  that record their calls: the wrapper runs up to the kernels' door."""
  calls = []
  monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda self: True))
  monkeypatch.setattr(flash_attention, '_stream', lambda t: 0)
  monkeypatch.setattr(cuda_build, 'library',
                      lambda source: _FakeLibrary(source, calls))
  ops.reset_launches()
  yield calls
  ops.reset_launches()


@pytest.mark.parametrize('dtype,source,prefix', [
    (torch.bfloat16, 'flash_attention_tc', 'mt3_flash_tc'),
    (torch.float32, 'flash_attention', 'mt3_flash_3xtf32')])
def test_kernel_route_takes_transposed_views_without_copies(
    fake_kernels, dtype, source, prefix):
  """bf16 goes to the bf16 tensor-core entry points, float32 to the split
  TF32 ones, each counted under its own route's keys;
  both get the strides of layers.attention's transposed [b, len, h, d]
  views, return outputs in the same layouts, copy nothing, and leave di to
  the dQ kernel (no multiply or sum in PyTorch); dQ runs before dK/dV,
  which reads its di."""
  b, lq, lk, h = 2, 192, 128, 3
  meta = dict(device='meta', dtype=dtype)
  q, k, v = (torch.empty(b, length, h, 64, **meta).transpose(1, 2)
             .requires_grad_() for length in (lq, lk, lk))
  do = torch.empty(b, lq, h, 64, **meta).transpose(1, 2)
  with _RecordOps() as recorded:
    o = flash_attention.flash_attention(q, k, v, causal=True, sm_scale=0.5)
    grads = torch.autograd.grad(o, (q, k, v), do)
  assert [c[:2] for c in fake_kernels] == [
      (source, f'{prefix}_fwd'), (source, f'{prefix}_dq'),
      (source, f'{prefix}_dkv')]
  q_st, kv_st = (lq * h * 64, 64, h * 64), (lk * h * 64, 64, h * 64)
  fwd, dq, dkv = (c[2] for c in fake_kernels)
  assert fwd['q'] == q_st and fwd['k'] == fwd['v'] == kv_st
  assert fwd['o'] == q_st                  # o comes back in q's layout
  assert dq['dout'] == dq['o'] == dq['dq'] == q_st
  assert dkv['dout'] == q_st and dkv['dk'] == dkv['dv'] == kv_st
  assert all(c[3] == (b, h, lq, lk, 1, 0.5) for c in fake_kernels)
  assert o.stride() == q.stride()
  assert [g.stride() for g in grads] == [t.stride() for t in (q, k, v)]
  # Outputs are allocated, saved tensors detached (views): nothing else.
  assert set(recorded.ops) <= {'empty_like', 'empty', 'detach'}, recorded.ops
  route = f'flash_attention_{flash_attention.ROUTES[dtype][2]}'
  assert ops.launch_counts() == {
      key: int(key in (f'{route}fwd', f'{route}dq', f'{route}dkv'))
      for key in ops.KERNELS}


def test_kernel_route_lays_out_an_expanded_gradient(fake_kernels):
  """The gradient of a sum() arrives with zero strides; the backward lays
  it out once before the kernels read it."""
  q = torch.empty(1, 2, 128, 64, device='meta',
                  dtype=torch.bfloat16).requires_grad_()
  flash_attention.flash_attention(q, q, q, causal=False).sum().backward()
  dq = next(c for c in fake_kernels if c[1] == 'mt3_flash_tc_dq')
  assert dq[2]['dout'] == (2 * 128 * 64, 128 * 64, 64)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_kernel_route_raises_on_layouts_it_cannot_take(fake_kernels, dtype):
  """A non-unit last-dim stride raises for both routes, and so do rows
  that do not start on 16-byte boundaries (both routes copy 16 bytes a
  thread): 68 bf16 elements are 136 bytes, 66 float32 elements 264; 68
  float32 elements (272 bytes) go through."""
  wide = torch.empty(1, 2, 128, 128, device='meta', dtype=dtype)
  with pytest.raises(ValueError, match='unit last-dim stride'):
    flash_attention.flash_attention(wide[..., ::2], wide[..., ::2],
                                    wide[..., ::2], causal=True)
  padded = torch.empty(1, 2, 128, 68, device='meta', dtype=dtype)[..., :64]
  if dtype == torch.bfloat16:
    with pytest.raises(ValueError, match='16-byte'):
      flash_attention.flash_attention(padded, padded, padded, causal=True)
  else:
    odd = torch.empty(1, 2, 128, 66, device='meta', dtype=dtype)[..., :64]
    with pytest.raises(ValueError, match='16-byte'):
      flash_attention.flash_attention(odd, odd, odd, causal=True)
    flash_attention.flash_attention(padded, padded, padded, causal=True)
    assert fake_kernels[-1][1] == 'mt3_flash_3xtf32_fwd'
    assert fake_kernels[-1][2]['q'] == (2 * 128 * 68, 128 * 68, 68)
  assert not any(c[1].endswith('_fwd') and c[0] == 'flash_attention_tc'
                 for c in fake_kernels)
