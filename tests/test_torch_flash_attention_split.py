"""The arithmetic of kernel C's float32 route (csrc/flash_attention.cu),
mirrored in numpy on the CPU, where no card can run the kernel itself.

The mirror follows the kernel's products: each float32 operand x splits
into hi = tf32(x), TF32 being round to nearest, ties away from zero, to 10
mantissa bits (the kernel's tf32_rna), and lo = x - hi, which the tensor
cores read truncated to TF32 (its top 19 bits); a product is
lo hi + hi lo into an accumulator of its own, then hi hi, one mma k-step of
8 depth indices at a time, each k-step's sum added to its float32
accumulator rounded toward zero (the tensor cores' sums may truncate: the
worse case); every tile's product starts from zero and joins the running
sum by a float32 add.  The forward's p v and the backward's dS k, p^T dO
and dS^T q take the accumulator's columns 2t and 2t + 1 of each 8-column
block as depth indices t and t + 4, and the matching rows of the other
operand in the same order (PERMUTATION).  Softmax, masks, lse and di are
float32, as in the kernel.

Checked on numpy-seeded inputs (b=2, h=2, d=64; 256 x 256 causal, 256 x
128 full, 200 x 136 causal with ragged tiles):
  (a) o, dq, dk, dv of the mirror against the function in float64 and
      against the port's plain float32 version (flash_attention_plain and
      autograd) with chip_smoke.py's float32 limits: o within
      FLASH_ATOL_F32 = 1e-4 and gradients within 1e-3 x (1 + |w|) of the
      plain version, and each output's largest error against float64 at
      most 4 times the plain version's own;
  (b) the mirror with a term of the split dropped (one TF32 product, or
      lo hi, or hi lo left out) misses the 4x limit on o;
  (c) the permuted p v equals the unpermuted one within float32 rounding.
"""

import numpy as np
import pytest
import torch

from mt3_tpu_torch.ops import flash_attention

torch.set_num_threads(2)

ATOL_F32 = 1e-4          # chip_smoke.FLASH_ATOL_F32, on o
GRAD_TOL_F32 = 1e-3      # chip_smoke.FLASH_GRAD_TOL_F32, x (1 + |w|)
F64_FACTOR = 4.0         # chip_smoke.FLASH_F64_FACTOR
TILE = 64
# Depth order of one mma k-step over an accumulator's 8-column block: lane
# t's columns 2t, 2t + 1 are depth indices t and t + 4.
PERMUTATION = np.array([0, 2, 4, 6, 1, 3, 5, 7])
CASES = [(256, 256, True), (256, 128, False), (200, 136, True)]


def tf32(x):
  """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
  zero: the kernel's (bits + 0x1000) & 0xffffe000."""
  bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
  return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
      np.float32)


def split(x):
  """(hi, lo) as the tensor cores read them: hi rounded, lo = x - hi
  truncated to its top 19 bits."""
  hi = tf32(x)
  lo = (x.astype(np.float32) - hi).astype(np.float32).view(np.uint32)
  return hi, (lo & np.uint32(0xFFFFE000)).view(np.float32)


def _add_rz(acc, partial):
  """float32 acc + float64 partial, rounded toward zero."""
  exact = acc.astype(np.float64) + partial
  out = exact.astype(np.float32)
  over = np.abs(out.astype(np.float64)) > np.abs(exact)
  out[over] = np.nextafter(out[over], np.float32(0))
  return out


def _product(a, b, terms, perm):
  """a [..., m, k] @ b [..., k, n] from zero, as the kernel forms one
  tile's product: `terms` of the split, 8 depth indices a k-step (in the
  order `perm` gives within each k-step), small terms in their own
  accumulator."""
  ah, al = split(a)
  bh, bl = split(b)
  parts = {'hi_hi': (ah, bh), 'lo_hi': (al, bh), 'hi_lo': (ah, bl),
           'one': (tf32(a), tf32(b))}
  shape = a.shape[:-1] + b.shape[-1:]
  big = np.zeros(shape, np.float32)
  small = np.zeros(shape, np.float32)
  for k0 in range(0, a.shape[-1], 8):
    idx = k0 + perm
    for term in terms:
      x, y = parts[term]
      partial = np.matmul(x[..., idx].astype(np.float64),
                          y[..., idx, :].astype(np.float64))
      if term in ('lo_hi', 'hi_lo'):
        small = _add_rz(small, partial)
      else:
        big = _add_rz(big, partial)
  return (big + small).astype(np.float32)


SPLIT = ('lo_hi', 'hi_lo', 'hi_hi')
IDENTITY = np.arange(8)


def _abt(a, b, terms):
  """a b^T over the head dim: the depth order is free (the kernel reads
  columns 4t..4t+3 of each 16), so the mirror keeps it."""
  return _product(a, np.swapaxes(b, -1, -2), terms, IDENTITY)


def _xb(x, tile, terms, perm=PERMUTATION):
  """x (a float32 accumulator, 64 columns) times tile (64 rows)."""
  return _product(x, tile, terms, perm)


def _pad(x, rows):
  pad = [(0, 0)] * x.ndim
  pad[-2] = (0, rows - x.shape[-2])
  return np.pad(x, pad)


def mirror(q, k, v, do, causal, terms=SPLIT, perm=PERMUTATION):
  """o, dq, dk, dv of the kernel's arithmetic, float32 inputs [b, h, len,
  64], sm_scale 1."""
  lq, lk = q.shape[-2], k.shape[-2]
  mq, mk = -(-lq // TILE) * TILE, -(-lk // TILE) * TILE
  q, do = _pad(q, mq), _pad(do, mq)
  k, v = _pad(k, mk), _pad(v, mk)
  mask_value = np.float32(flash_attention.MASK_VALUE)

  def masked(s, q0, k0, keys_are_rows=False):
    """Scores of query rows q0.. and key columns k0.. (or transposed):
    + the mask constant where causal hides the key, -inf past lk."""
    r = np.arange(s.shape[-2])[:, None]
    c = np.arange(s.shape[-1])[None, :]
    keys, queries = (k0 + r, q0 + c) if keys_are_rows else (k0 + c, q0 + r)
    if causal:
      s = np.where(keys > queries, s + mask_value, s)
    return np.where(keys >= lk, -np.inf, s).astype(np.float32)

  # Forward: online softmax over key tiles.
  m = np.full(q.shape[:-1], -np.inf, np.float32)
  l = np.zeros(q.shape[:-1], np.float32)
  acc = np.zeros(q.shape, np.float32)
  for k0 in range(0, mk, TILE):
    s = masked(_abt(q, k[..., k0:k0 + TILE, :], terms), 0, k0)
    mx = np.maximum(m, s.max(-1))
    alpha = np.exp(m - mx).astype(np.float32)
    p = np.exp(s - mx[..., None]).astype(np.float32)
    l = (l * alpha + p.sum(-1, dtype=np.float32)).astype(np.float32)
    m = mx
    acc = (acc * alpha[..., None]
           + _xb(p, v[..., k0:k0 + TILE, :], terms, perm)).astype(np.float32)
  o = (acc / l[..., None]).astype(np.float32)
  lse = (m + np.log(l)).astype(np.float32)

  # dQ, with di = rowsum(o * dO).
  di = (o * do).sum(-1, dtype=np.float32)
  dq = np.zeros(q.shape, np.float32)
  for k0 in range(0, mk, TILE):
    kt, vt = k[..., k0:k0 + TILE, :], v[..., k0:k0 + TILE, :]
    p = np.exp(masked(_abt(q, kt, terms), 0, k0) - lse[..., None])
    dp = _abt(do, vt, terms)
    ds = (p * (dp - di[..., None])).astype(np.float32)
    dq = (dq + _xb(ds, kt, terms, perm)).astype(np.float32)

  # dK/dV: rows are keys; rows past lq hold zeros (q, dO, lse, di).
  lse_p = np.where(np.arange(mq) < lq, lse, 0).astype(np.float32)
  di_p = np.where(np.arange(mq) < lq, di, 0).astype(np.float32)
  dk = np.zeros(k.shape, np.float32)
  dv = np.zeros(v.shape, np.float32)
  for q0 in range(0, mq, TILE):
    qt, dot = q[..., q0:q0 + TILE, :], do[..., q0:q0 + TILE, :]
    st = masked(_abt(k, qt, terms), q0, 0, keys_are_rows=True)
    pt = np.exp(st - lse_p[..., None, q0:q0 + TILE]).astype(np.float32)
    dv = (dv + _xb(pt, dot, terms, perm)).astype(np.float32)
    dpt = _abt(v, dot, terms)
    dst = (pt * (dpt - di_p[..., None, q0:q0 + TILE])).astype(np.float32)
    dk = (dk + _xb(dst, qt, terms, perm)).astype(np.float32)
  return o[..., :lq, :], dq[..., :lq, :], dk[..., :lk, :], dv[..., :lk, :]


def _inputs(lq, lk, seed):
  rng = np.random.RandomState(seed)
  q = (rng.randn(2, 2, lq, 64) / 8).astype(np.float32)
  k, v = (rng.randn(2, 2, lk, 64).astype(np.float32) for _ in range(2))
  do = (0.5 * rng.randn(2, 2, lq, 64)).astype(np.float32)
  return q, k, v, do


def _autograd(q, k, v, do, causal, dtype):
  """o and its gradients through the port's plain version in float32, or
  the same function computed in float64 throughout."""
  args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
  if dtype == torch.float32:
    o = flash_attention.flash_attention_plain(*args, causal)
  else:
    s = args[0] @ args[1].transpose(-1, -2)
    if causal:
      r = torch.arange(q.shape[-2])[:, None]
      c = torch.arange(k.shape[-2])[None, :]
      s = s + torch.where(c <= r, 0.0, flash_attention.MASK_VALUE).to(dtype)
    o = torch.softmax(s, -1) @ args[2]
  grads = torch.autograd.grad(o, args, torch.from_numpy(do).to(dtype))
  return [x.detach().to(torch.float64).numpy() for x in (o, *grads)]


@pytest.fixture(scope='module')
def references():
  out = {}
  for lq, lk, causal in CASES:
    inputs = _inputs(lq, lk, lq + lk + causal)
    out[(lq, lk, causal)] = (inputs,
                             _autograd(*inputs, causal, torch.float64),
                             _autograd(*inputs, causal, torch.float32))
  return out


def _errors(got, want):
  return [float(np.abs(g.astype(np.float64) - w).max())
          for g, w in zip(got, want)]


@pytest.mark.parametrize('lq,lk,causal', CASES)
def test_split_products_keep_float32_accuracy(references, lq, lk, causal):
  inputs, f64, plain = references[(lq, lk, causal)]
  got = mirror(*inputs, causal)
  for name, g, w in zip(('o', 'dq', 'dk', 'dv'), got, plain):
    assert np.isfinite(g).all(), name
    if name == 'o':
      assert np.abs(g - w).max() <= ATOL_F32, name
    else:
      excess = np.abs(g - w) - GRAD_TOL_F32 * (1 + np.abs(w))
      assert excess.max() <= 0, (name, np.abs(g - w).max())
  for name, e, e_plain in zip(('o', 'dq', 'dk', 'dv'), _errors(got, f64),
                              _errors(plain, f64)):
    assert e <= F64_FACTOR * e_plain, (name, e, e_plain)


@pytest.mark.parametrize('terms', [('one',), ('hi_lo', 'hi_hi'),
                                   ('lo_hi', 'hi_hi')],
                         ids=['one_tf32_product', 'lo_hi_dropped',
                              'hi_lo_dropped'])
def test_a_dropped_term_misses_the_limit(references, terms):
  lq, lk, causal = CASES[0]
  inputs, f64, plain = references[(lq, lk, causal)]
  o = mirror(*inputs, causal, terms=terms)[0]
  e, e_plain = _errors([o], f64[:1])[0], _errors(plain[:1], f64[:1])[0]
  assert e > F64_FACTOR * e_plain, (terms, e, e_plain)


def test_permuted_pv_equals_unpermuted():
  rng = np.random.RandomState(7)
  p = np.exp(rng.randn(2, 2, 64, 64)).astype(np.float32)
  v = rng.randn(2, 2, 64, 64).astype(np.float32)
  permuted = _xb(p, v, SPLIT)
  unpermuted = _xb(p, v, SPLIT, IDENTITY)
  scale = np.matmul(np.abs(p).astype(np.float64), np.abs(v))
  eps = np.finfo(np.float32).eps
  assert not np.array_equal(PERMUTATION, IDENTITY)
  np.testing.assert_array_less(np.abs(permuted - unpermuted),
                               16 * eps * scale + 1e-30)
  np.testing.assert_allclose(permuted, np.matmul(p.astype(np.float64), v),
                             rtol=0, atol=float((16 * eps * scale).max()))


def test_tf32_rounds_to_nearest_ties_away():
  one = np.float32(1.0)
  ulp = np.float32(2.0 ** -10)
  x = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                1 + 3 * 2.0 ** -11, 0.0], np.float32)
  np.testing.assert_array_equal(
      tf32(x), np.array([one + ulp, -(one + ulp), one, one + 2 * ulp, 0.0],
                        np.float32))
  x = np.float32(np.pi)
  hi, lo = (part[0] for part in split(np.array([x])))
  assert abs(float(hi) + float(lo) - float(x)) <= 2.0 ** -21 * float(x)
