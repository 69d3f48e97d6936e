"""Decode attention of the PyTorch port vs the JAX package.

The plain version of the port's decode-attention kernel
(mt3_tpu_torch/ops/decode_attention.py) against the Pallas TPU kernel it
replaces, run in interpret mode as tests/test_pallas_decode_attention.py
runs it, against the XLA decode path of layers.attention_decode_step, and,
for grouped and quantized caches, against each branch of
layers._cached_attention_math.  Float32; outputs within atol 1e-5, caches
equal.  The CUDA kernels' split recurrences (multi-head, and grouped with
the scales folded in) are mirrored in torch, and the wrapper is run up to
the library's door against a fake library.  The grouped mirror follows
the wrapper's split rule (decode_attention.grouped_split) in both regimes:
64-position blocks merged in the launch, and one block walking the whole
prefix where b * kv fills the card.  In bf16 (weights * v_scale rounded to
bf16 before the V product, as the tensor-core kernel rounds them) it is
held against _cached_attention_math run in bf16 within 1e-2 x (1 + |out|),
the tolerance the card holds kernel B to in bf16.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt3_tpu.models import layers as jax_layers
from mt3_tpu.ops.pallas import decode_attention_v3
from mt3_tpu_torch import ops
from mt3_tpu_torch.models import layers
from mt3_tpu_torch.ops import cuda_build, decode_attention

torch.set_num_threads(2)

B, H, D, LEN = 16, 6, 64, 512


def _inputs(index, seed=3):
  rng = np.random.RandomState(seed + index)
  query, new_k, new_v = (rng.randn(B, H, D).astype(np.float32)
                         for _ in range(3))
  # The cache holds positions < index; position index arrives as new_k/v.
  mask = (np.arange(LEN) < index).astype(np.float32)
  cache_k = rng.randn(B, H, D, LEN).astype(np.float32) * mask
  cache_v = rng.randn(B, H, D, LEN).astype(np.float32) * mask
  return query, new_k, new_v, cache_k, cache_v


def _port(query, new_k, new_v, cache_k, cache_v, index):
  ck, cv = torch.from_numpy(cache_k.copy()), torch.from_numpy(cache_v.copy())
  out = decode_attention.decode_attention_inplace(
      torch.from_numpy(query), torch.from_numpy(new_k),
      torch.from_numpy(new_v), ck, cv,
      torch.tensor(index, dtype=torch.int32))
  return out.numpy(), ck.numpy(), cv.numpy()


@pytest.mark.parametrize('index', [0, 5, 127, 128, 300, 511])
def test_plain_matches_pallas_kernel(index):
  query, new_k, new_v, cache_k, cache_v = _inputs(index)
  ref_out, ref_ck, ref_cv = decode_attention_v3.decode_attention_inplace(
      query, new_k, new_v, cache_k, cache_v, jnp.array(index),
      interpret=True)
  out, ck, cv = _port(query, new_k, new_v, cache_k, cache_v, index)
  np.testing.assert_allclose(out, np.asarray(ref_out), atol=1e-5, rtol=1e-5)
  np.testing.assert_array_equal(ck, np.asarray(ref_ck))
  np.testing.assert_array_equal(cv, np.asarray(ref_cv))
  # Positions after index are untouched.
  np.testing.assert_array_equal(ck[..., index + 1:], cache_k[..., index + 1:])


@pytest.mark.parametrize('impl', ['xla', 'pallas_v3'])
# LEN + 7: dynamic_update_slice clamps the write to the last column.
@pytest.mark.parametrize('index', [0, 130, 511, LEN + 7])
def test_attention_decode_step_matches_jax_xla(index, impl):
  emb, h, d, b, max_len = 64, 4, 16, 3, LEN
  rng = np.random.RandomState(index)
  params = {name: (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)
            for name, shape in (('query', (emb, h * d)), ('key', (emb, h * d)),
                                ('value', (emb, h * d)), ('out', (h * d, emb)))}
  x = rng.randn(b, emb).astype(np.float32)
  mask = (np.arange(max_len) < index).astype(np.float32)
  cache_k = rng.randn(b, h, d, max_len).astype(np.float32) * mask
  cache_v = rng.randn(b, h, d, max_len).astype(np.float32) * mask

  ref_out, ref_ck, ref_cv = jax_layers.attention_decode_step(
      params, x, cache_k, cache_v, jnp.array(index, jnp.int32), h, d,
      attention_impl='xla')
  ck, cv = torch.from_numpy(cache_k.copy()), torch.from_numpy(cache_v.copy())
  out, ck2, cv2 = layers.attention_decode_step(
      {k: torch.from_numpy(v) for k, v in params.items()},
      torch.from_numpy(x), ck, cv, torch.tensor(index, dtype=torch.int32),
      h, d, attention_impl=impl)
  assert ck2 is ck and cv2 is cv  # written in place
  np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
  np.testing.assert_array_equal(ck.numpy(), np.asarray(ref_ck))
  np.testing.assert_array_equal(cv.numpy(), np.asarray(ref_cv))


def test_plain_bf16_close_to_float32():
  """bf16 caches (the served dtype) against the port's own float32.

  Tolerance 5e-2: bf16 keeps 8 bits of mantissa and the plain version
  rounds logits, weights and output to bf16 as the XLA path does.  The
  query is scaled by 1/sqrt(d), as T5 folds that scale into its weights.
  """
  index = 300
  query, new_k, new_v, cache_k, cache_v = _inputs(index, seed=11)
  query = query / np.sqrt(D)
  out32, _, _ = _port(query, new_k, new_v, cache_k, cache_v, index)
  as_bf16 = [torch.from_numpy(a.copy()).to(torch.bfloat16)
             for a in (query, new_k, new_v, cache_k, cache_v)]
  out16 = decode_attention.decode_attention_inplace(
      *as_bf16, torch.tensor(index, dtype=torch.int32))
  assert out16.dtype == torch.bfloat16
  np.testing.assert_allclose(out16.float().numpy(), out32, atol=5e-2)
  assert torch.equal(as_bf16[3][..., index], as_bf16[1])



L_SPLIT = decode_attention.L_SPLIT


def _split_recurrence(query, new_k, new_v, cache_k, cache_v, index):
  """csrc/decode_attention.cu's arithmetic in torch, float32: (m, l, acc)
  of each split of L_SPLIT positions over j < index, then the combine with
  position index, which enters from new_k/new_v.  Writes the column like
  the kernel.  Returns (out, the number of splits that read the cache)."""
  length = cache_k.shape[-1]
  index = min(max(index, 0), length - 1)
  parts = []
  for p0 in range(0, length, L_SPLIT):
    if p0 >= index:
      continue
    k = cache_k[..., p0:min(p0 + L_SPLIT, index)]
    v = cache_v[..., p0:min(p0 + L_SPLIT, index)]
    logits = torch.einsum('bhd,bhdl->bhl', query, k)
    m = logits.max(dim=-1).values
    p = torch.exp(logits - m[..., None])
    parts.append((m, p.sum(-1), torch.einsum('bhl,bhdl->bhd', p, v)))
  s_new = (query * new_k).sum(-1)
  m = s_new
  for m_s, _, _ in parts:
    m = torch.maximum(m, m_s)
  p_new = torch.exp(s_new - m)
  l, acc = p_new, p_new[..., None] * new_v
  for m_s, l_s, acc_s in parts:
    scale = torch.exp(m_s - m)
    l = l + scale * l_s
    acc = acc + scale[..., None] * acc_s
  cache_k[..., index] = new_k
  cache_v[..., index] = new_v
  return acc / l[..., None], len(parts)


@pytest.mark.parametrize('index', [0, 1, L_SPLIT - 1, L_SPLIT, L_SPLIT + 1,
                                   2 * L_SPLIT, LEN - 1, LEN + 7])
def test_split_recurrence_matches_plain(index):
  """The kernel's split-and-combine against the plain version at the split
  boundaries, the last column and past the end (clamped)."""
  query, new_k, new_v, cache_k, cache_v = _inputs(min(index, LEN - 1), seed=5)
  args = [torch.from_numpy(a.copy()) for a in (query, new_k, new_v,
                                               cache_k, cache_v)]
  got, read = _split_recurrence(*args, index)
  want, ck, cv = _port(query, new_k, new_v, cache_k, cache_v, index)
  assert read == -(-min(index, LEN - 1) // L_SPLIT)
  np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
  np.testing.assert_array_equal(args[3].numpy(), ck)
  np.testing.assert_array_equal(args[4].numpy(), cv)


class _FakeEntry:
  """mt3_decode_attention that records its arguments, reports success."""

  def __init__(self):
    self.argtypes, self.calls = None, []

  def __call__(self, *args):
    self.calls.append(args)
    return 0


@pytest.fixture
def fake_kernel(monkeypatch):
  """CPU tensors pass for CUDA ones and the built library is a fake; the
  workspaces the wrapper hands the kernel are kept for inspection.
  Yields the MHA entry's calls, the workspaces and the grouped entry's
  calls."""
  entry, grouped, workspaces = _FakeEntry(), _FakeEntry(), []
  workspace = decode_attention._workspace

  def spy(query, splits, grouped=False):
    workspaces.append(workspace(query, splits, grouped))
    return workspaces[-1]
  monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda self: True))
  monkeypatch.setattr(decode_attention, '_stream', lambda t: 0)
  monkeypatch.setattr(decode_attention, '_COUNTERS', {})
  monkeypatch.setattr(decode_attention, '_workspace', spy)
  monkeypatch.setattr(
      cuda_build, 'library',
      lambda name: types.SimpleNamespace(
          mt3_decode_attention=entry, mt3_decode_attention_grouped=grouped))
  ops.reset_launches()
  yield entry.calls, workspaces, grouped.calls
  ops.reset_launches()


@pytest.mark.parametrize('dtype,code', [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize('d,length', [(8, 100), (16, 320), (64, 1024)])
def test_kernel_wrapper_arguments(fake_kernel, dtype, code, d, length):
  """Scratch [b*h, S, d+2] float32 with S = ceil(len / L_SPLIT), the
  device's zeroed counter buffer (the same one on every call), and one
  launch counted per call."""
  calls, workspaces, _ = fake_kernel
  b, h = 3, 4
  q, nk, nv = (torch.zeros(b, h, d, dtype=dtype) for _ in range(3))
  ck, cv = (torch.zeros(b, h, d, length, dtype=dtype) for _ in range(2))
  index = torch.tensor(5, dtype=torch.int32)
  outs = [decode_attention._launch(q, nk, nv, ck, cv, index)
          for _ in range(2)]
  splits = -(-length // L_SPLIT)
  assert len(calls) == len(workspaces) == 2
  for args, (partials, counters), out in zip(calls, workspaces, outs):
    assert partials.shape == (b * h, splits, d + 2)
    assert partials.dtype == torch.float32
    assert counters.dtype == torch.int32 and counters.numel() >= b * h
    assert not counters.any()
    assert args[:9] == tuple(t.data_ptr() for t in (
        q, nk, nv, ck, cv, index, out, partials, counters))
    assert args[9:] == (b * h, d, length, splits, code, 0)
    assert out.shape == q.shape and out.dtype == dtype
  assert workspaces[0][1] is workspaces[1][1]
  assert ops.launch_counts()['decode_attention_mha'] == 2


@pytest.mark.parametrize('case', ['non_contiguous', 'mixed_dtypes',
                                  'head_dim_32'])
def test_kernel_wrapper_raises(fake_kernel, case):
  calls, _, _ = fake_kernel
  d = 32 if case == 'head_dim_32' else 64
  q, nk, nv = (torch.zeros(2, 3, d) for _ in range(3))
  ck, cv = (torch.zeros(2, 3, d, 128) for _ in range(2))
  if case == 'non_contiguous':
    ck = torch.zeros(2, 3, 128, d).transpose(-1, -2)
  elif case == 'mixed_dtypes':
    cv = cv.to(torch.bfloat16)
  with pytest.raises(ValueError):
    decode_attention._launch(q, nk, nv, ck, cv,
                             torch.tensor(3, dtype=torch.int32))
  assert not calls and not any(ops.launch_counts().values())


# ---------------------------------------------------------------------------
# Grouped and quantized caches
# ---------------------------------------------------------------------------
def _grouped_inputs(kv, bits, index, seed, h=6, d=8, b=3, length=200):
  """query [b, h, d], new K/V [b, kv, d], caches (int8 codes, packed int4
  or float32) holding positions < index, and scales (or None)."""
  rng = np.random.RandomState(seed)
  query = (rng.randn(b, h, d) / np.sqrt(d)).astype(np.float32)
  new_k, new_v = (rng.randn(b, kv, d).astype(np.float32) for _ in range(2))
  live = np.arange(length) < index
  if bits is None:
    caches = [(rng.randn(b, kv, d, length) * live).astype(np.float32)
              for _ in range(2)]
    return query, new_k, new_v, caches, None
  levels = 7 if bits == 4 else 127
  caches = [(rng.randint(-levels, levels + 1, (b, kv, d, length))
             * live).astype(np.int8) for _ in range(2)]
  scales = [(rng.uniform(0.2, 1.0, (b, kv, length)) / levels
             * live).astype(np.float32) for _ in range(2)]
  return query, new_k, new_v, caches, scales


def _to_port(caches, scales, bits):
  port = [torch.from_numpy(c.copy()) for c in caches]
  if bits == 4:
    port = [decode_attention.pack_int4(c) for c in port]
  return port, ([torch.from_numpy(s.copy()) for s in scales]
                if scales is not None else [None, None])


# (kv heads of 6, bits): the four branches of _cached_attention_math.
BRANCHES = [(3, None), (1, None), (6, 8), (6, 4), (2, 8), (1, 4)]


@pytest.mark.parametrize('kv,bits', BRANCHES)
def test_attention_plain_matches_jax_cached_math(kv, bits):
  """attention_plain over a written cache against the branch of
  _cached_attention_math for the same cache (float32, atol 1e-5)."""
  index, h, d, b, length = 130, 6, 8, 3, 200
  query, _, _, caches, scales = _grouped_inputs(kv, bits, index + 1, seed=kv)
  jax_caches = [jnp.asarray(c).astype(jnp.int4 if bits == 4 else c.dtype)
                for c in caches]
  jax_scales = [jnp.asarray(s) for s in scales] if scales else [None, None]
  ref = jax_layers._cached_attention_math(
      jnp.asarray(query).reshape(b, kv, h // kv, d), *jax_caches,
      *jax_scales, jnp.array(index, jnp.int32), length, b, h, d, h // kv,
      jnp.float32, 'xla')
  port_caches, port_scales = _to_port(caches, scales, bits)
  out = decode_attention.attention_plain(
      torch.from_numpy(query), *port_caches,
      torch.tensor(index, dtype=torch.int32), *port_scales)
  np.testing.assert_allclose(out.reshape(b, h * d).numpy(), np.asarray(ref),
                             atol=1e-5, rtol=0)


WARPS = 4                 # csrc/decode_attention.cu kGroupedWarps
WARP_POSITIONS = L_SPLIT // WARPS


def _softmax_state(q, keys, values, k_scale, v_scale, positions, dtype):
  """One warp's online softmax over its positions, tile by tile: logits
  over the codes in float32, times k_scale; the running max rescales l and
  acc; the weights p * v_scale are rounded to `dtype` before the V
  product.  Returns (m, l, acc) per query head (m -1e30 where nothing
  was read)."""
  b, kv, g, d = q.shape
  m = torch.full((b, kv, g), -1e30)
  l = torch.zeros(b, kv, g)
  acc = torch.zeros(b, kv, g, d)
  for pos in positions:
    if not pos:
      continue
    s = torch.einsum('bkgd,bkdl->bkgl', q, keys[..., pos])
    if k_scale is not None:
      s = s * k_scale[:, :, None, pos]
    m_new = torch.maximum(m, s.max(dim=-1).values)
    rescale = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    w = p * v_scale[:, :, None, pos] if v_scale is not None else p
    w = w.to(dtype).float()
    l = l * rescale + p.sum(-1)
    acc = acc * rescale[..., None] + torch.einsum('bkgl,bkdl->bkgd', w,
                                                  values[..., pos])
    m = m_new
  return m, l, acc


def _merge(states):
  """States (m, l, acc) over disjoint positions -> one, in float32."""
  m = states[0][0]
  for m_s, _, _ in states[1:]:
    m = torch.maximum(m, m_s)
  l = sum(torch.exp(m_s - m) * l_s for m_s, l_s, _ in states)
  acc = sum(torch.exp(m_s - m)[..., None] * a_s for m_s, _, a_s in states)
  return m, l, acc


def _grouped_recurrence(query, new_k, new_v, cache_k, cache_v, index,
                        k_scale=None, v_scale=None):
  """The grouped kernels' arithmetic in torch, sums in float32: blocks of
  `span` positions by decode_attention.grouped_split (a static function of
  b * kv and the cache length); in each block, warp w takes positions
  16w .. 16w + 15 of every 64-position tile below index with its own online
  softmax (weights * v_scale rounded to the query's dtype), and the warps'
  states merge; the blocks' states (one block: its own) merge with the new
  column, quantized as the kernel quantizes it and entering from its codes,
  its weight rounded as the tiles' are; the column written as the kernel
  writes it.  Returns (out in the query's dtype, blocks that read the
  cache, splits)."""
  length = cache_k.shape[-1]
  index = min(max(index, 0), length - 1)
  quant = k_scale is not None
  dtype = query.dtype
  keys = (decode_attention.cache_codes(cache_k) if quant else cache_k).float()
  values = (decode_attention.cache_codes(cache_v) if quant
            else cache_v).float()
  b, h, d = query.shape
  kv = keys.shape[1]
  q = query.float().reshape(b, kv, h // kv, d)
  span, splits = decode_attention.grouped_split(b * kv, length)
  blocks = []
  for p_begin in range(0, min(index, length), span):
    p_end = min(p_begin + span, index)
    blocks.append(_merge([
        _softmax_state(q, keys, values, k_scale, v_scale, [
            [p for p in range(p0 + w * WARP_POSITIONS,
                              p0 + (w + 1) * WARP_POSITIONS) if p < p_end]
            for p0 in range(p_begin, p_end, L_SPLIT)], dtype)
        for w in range(WARPS)]))
  if quant:
    bits = 4 if cache_k.dtype == torch.uint8 else 8
    (col_k, ks), (col_v, vs) = (decode_attention.quantize_kv(x, bits)
                                for x in (new_k, new_v))
    col_k, col_v = col_k.float(), col_v.float()
  else:
    col_k, col_v = new_k.float(), new_v.float()
    ks = vs = torch.ones(new_k.shape[:2])
  s_new = torch.einsum('bkgd,bkd->bkg', q, col_k) * ks[..., None]
  m, l, acc = _merge(blocks + [(s_new, torch.ones_like(s_new),
                                torch.zeros(b, kv, h // kv, d))])
  p_new = torch.exp(s_new - m)
  acc = acc + ((p_new * vs[..., None]).to(dtype).float()[..., None]
               * col_v[:, :, None, :])
  decode_attention.write_column(new_k, new_v, cache_k, cache_v,
                                torch.tensor(index), k_scale, v_scale)
  out = (acc / l[..., None]).reshape(b, h, d).to(dtype)
  return out, len(blocks), splits


# (regime, b): b * kv rows well below GROUPED_BLOCKS (several blocks per
# row, merged in the launch), or at it (one block walks the whole length).
def _batch(regime, kv):
  return 3 if regime == 'split' else -(-decode_attention.GROUPED_BLOCKS // kv)


GROUPED_LENGTH = 200
# Every tile boundary of a 200-position cache, the last column and past
# the end (clamped).
GROUPED_INDICES = [0, 1, L_SPLIT - 1, L_SPLIT, L_SPLIT + 1, 2 * L_SPLIT - 1,
                   2 * L_SPLIT, 2 * L_SPLIT + 1, 3 * L_SPLIT - 1, 3 * L_SPLIT,
                   3 * L_SPLIT + 1, GROUPED_LENGTH - 1, GROUPED_LENGTH + 5]


@pytest.mark.parametrize('index', GROUPED_INDICES)
@pytest.mark.parametrize('kv,bits', [(2, None), (6, 8), (3, 4), (1, 4)])
@pytest.mark.parametrize('regime', ['split', 'whole'])
def test_grouped_recurrence_matches_plain(regime, kv, bits, index):
  """The grouped kernels' blocks, warps and merges, with the scales folded
  in and the new column from its codes, against the plain version in
  float32, in both regimes of the split rule, at every tile boundary, the
  last column and past the end (clamped): out within 1e-5, caches and
  scales equal to the plain write."""
  length = GROUPED_LENGTH
  b = _batch(regime, kv)
  query, new_k, new_v, caches, scales = _grouped_inputs(
      kv, bits, min(index, length - 1), seed=index + kv, b=b, length=length)
  mirror_caches, mirror_scales = _to_port(caches, scales, bits)
  plain_caches, plain_scales = _to_port(caches, scales, bits)
  args = [torch.from_numpy(a) for a in (query, new_k, new_v)]
  got, read, splits = _grouped_recurrence(*args, *mirror_caches, index,
                                          *mirror_scales)
  want = decode_attention.decode_attention_inplace(
      *args, *plain_caches, torch.tensor(index, dtype=torch.int32),
      *plain_scales)
  span, _ = decode_attention.grouped_split(b * kv, length)
  assert splits == (1 if regime == 'whole' else -(-length // L_SPLIT))
  assert read == -(-min(index, length - 1) // span)
  np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
  for a, b in zip(mirror_caches + mirror_scales,
                  plain_caches + plain_scales):
    if a is not None:
      assert torch.equal(a, b)


@pytest.mark.parametrize('index', [0, L_SPLIT - 1, L_SPLIT + 1, 130,
                                   GROUPED_LENGTH - 1])
@pytest.mark.parametrize('kv,bits', BRANCHES)
@pytest.mark.parametrize('regime', ['split', 'whole'])
def test_grouped_recurrence_bf16_matches_jax(regime, kv, bits, index):
  """The mirror in bf16 (bf16 query and new K/V; weights * v_scale rounded
  to bf16 before the V product, as the tensor-core kernel rounds them)
  against the matching branch of _cached_attention_math run in bf16 on the
  CPU over the same written cache: within 1e-2 x (1 + |out|), the
  tolerance the card holds kernel B to in bf16 (JAX also rounds the logits
  and the output of each product to bf16)."""
  h, d, length = 6, 8, GROUPED_LENGTH
  b = _batch(regime, kv)
  query, new_k, new_v, caches, scales = _grouped_inputs(
      kv, bits, index, seed=3 * index + kv, b=b, length=length)
  port_caches, port_scales = _to_port(caches, scales, bits)
  if bits is None:
    port_caches = [c.to(torch.bfloat16) for c in port_caches]
  args = [torch.from_numpy(a).to(torch.bfloat16)
          for a in (query, new_k, new_v)]
  got, _, _ = _grouped_recurrence(*args, *port_caches, index, *port_scales)
  # JAX over the cache the mirror wrote (codes and scales, or bf16 values).
  written = [decode_attention.cache_codes(c) if bits else c
             for c in port_caches]
  jax_caches = [jnp.asarray(c.float().numpy()).astype(
      jnp.int4 if bits == 4 else jnp.int8 if bits else jnp.bfloat16)
      for c in written]
  jax_scales = ([jnp.asarray(s.numpy()) for s in port_scales]
                if bits else [None, None])
  ref = jax_layers._cached_attention_math(
      jnp.asarray(args[0].float().numpy()).astype(jnp.bfloat16).reshape(
          b, kv, h // kv, d), *jax_caches, *jax_scales,
      jnp.array(index, jnp.int32), length, b, h, d, h // kv, jnp.bfloat16,
      'xla')
  want = np.asarray(ref.astype(jnp.float32)).reshape(b, h, d)
  diff = np.abs(got.float().numpy() - want)
  assert got.dtype == torch.bfloat16
  assert (diff <= 1e-2 * (1 + np.abs(want))).all(), float(diff.max())


@pytest.mark.parametrize('rows', [1, 3, 8, 48, 100, 128, 512, 1000, 1023,
                                  1024, 1025, 6144, 65535])
@pytest.mark.parametrize('length', [1, 64, 100, 200, 1000, 1024, 2048])
def test_grouped_split_rule(rows, length):
  """span is a multiple of L_SPLIT and splits = ceil(length / span) blocks
  cover the cache with none empty of positions; rows * splits does not
  exceed the larger of GROUPED_BLOCKS and rows (one block per row at rows
  >= GROUPED_BLOCKS), and come to at least half of what the target asks
  for, never finer than one tile a block.  The
  rule reads no index, so one shape keeps one grid."""
  span, splits = decode_attention.grouped_split(rows, length)
  tiles = -(-length // L_SPLIT)
  assert span % L_SPLIT == 0 and span >= L_SPLIT
  assert splits == -(-length // span) and (splits - 1) * span < length
  assert 1 <= splits <= tiles
  if rows >= decode_attention.GROUPED_BLOCKS:
    assert (span, splits) == (tiles * L_SPLIT, 1)
  else:
    assert rows * splits <= max(decode_attention.GROUPED_BLOCKS, rows)
    # At least half as many splits as the target asks for (ceil effects).
    wanted = min(tiles, max(1, decode_attention.GROUPED_BLOCKS // rows))
    assert 2 * splits >= wanted
  assert decode_attention.grouped_split(rows, length) == (span, splits)


def test_plain_quantized_bf16_close_to_float32():
  """int4 GQA-1, bf16 query (the served dtype) against the port's own
  float32 on the same caches: within 1e-2 x (1 + |out|), the tolerance the
  card holds kernel B to in bf16 (the JAX branch rounds the logits to
  bf16 before the scales)."""
  query, new_k, new_v, caches, scales = _grouped_inputs(1, 4, 150, seed=9)
  outs = {}
  for dtype in (torch.float32, torch.bfloat16):
    port_caches, port_scales = _to_port(caches, scales, 4)
    args = [torch.from_numpy(a).to(dtype) for a in (query, new_k, new_v)]
    outs[dtype] = decode_attention.decode_attention_inplace(
        *args, *port_caches, torch.tensor(150, dtype=torch.int32),
        *port_scales)
  assert outs[torch.bfloat16].dtype == torch.bfloat16
  want = outs[torch.float32]
  diff = (outs[torch.bfloat16].float() - want).abs()
  assert bool((diff <= 1e-2 * (1 + want.abs())).all()), float(diff.max())


@pytest.mark.parametrize('kind,kv', [('float32', 2), ('bfloat16', 1),
                                     ('int8', 6), ('int4', 3)])
@pytest.mark.parametrize('regime', ['split', 'whole'])
def test_grouped_kernel_wrapper_arguments(fake_kernel, regime, kind, kv):
  """Float caches with shared K/V heads and every quantized cache go to
  the grouped entry: pointers, (b*kv, g, d, len, span, splits, dtype,
  cache kind) with (span, splits) from grouped_split; partials [b*h,
  splits, d+2] with several splits, none (a null pointer) with one; one
  launch counted, under its variant."""
  mha_calls, workspaces, calls = fake_kernel
  h, d, length = 6, 64, 300
  b = 2 if regime == 'split' else -(-decode_attention.GROUPED_BLOCKS // kv)
  dtype = torch.bfloat16 if kind == 'bfloat16' else torch.float32
  cache_dtype = {'int8': torch.int8, 'int4': torch.uint8}.get(kind, dtype)
  rows = d // 2 if kind == 'int4' else d
  q = torch.zeros(b, h, d, dtype=dtype)
  nk, nv = (torch.zeros(b, kv, d, dtype=dtype) for _ in range(2))
  ck, cv = (torch.zeros(b, kv, rows, length, dtype=cache_dtype)
            for _ in range(2))
  scales = ([torch.zeros(b, kv, length) for _ in range(2)]
            if kind.startswith('int') else [None, None])
  index = torch.tensor(7, dtype=torch.int32)
  out = decode_attention._launch(q, nk, nv, ck, cv, index, *scales)
  assert not mha_calls and len(calls) == 1
  args = calls[0]
  partials, counters = workspaces[0]
  span, splits = decode_attention.grouped_split(b * kv, length)
  if regime == 'split':
    assert (span, splits) == (L_SPLIT, -(-length // L_SPLIT))
    assert partials.shape == (b * h, splits, d + 2)
  else:
    assert (span, splits) == (-(-length // L_SPLIT) * L_SPLIT, 1)
    assert partials is None
  assert args[:11] == tuple(
      t.data_ptr() if t is not None else None
      for t in (q, nk, nv, ck, cv, *scales, index, out, partials, counters))
  assert args[11:] == (b * kv, h // kv, d, length, span, splits,
                       {torch.float32: 0, torch.bfloat16: 1}[dtype],
                       {'float32': 0, 'bfloat16': 1, 'int8': 2,
                        'int4': 3}[kind], 0)
  name = decode_attention.variant(ck, h // kv)
  assert name == {'float32': 'gqa', 'bfloat16': 'gqa', 'int8': 'int8',
                  'int4': 'int4_gqa'}[kind]
  assert {k: n for k, n in ops.launch_counts().items() if n} == {
      f'decode_attention_{name}': 1}


@pytest.mark.parametrize('case', ['scales_on_float_cache', 'int8_no_scales',
                                  'int4_rows', 'group_of_12',
                                  'float16_scales', 'one_scale'])
def test_grouped_kernel_wrapper_raises(fake_kernel, case):
  """Combinations neither kernel takes raise before any launch."""
  _, _, calls = fake_kernel
  b, h, d, length = 2, 6, 8, 64
  q = torch.zeros(b, h * (2 if case == 'group_of_12' else 1), d)
  kv = 1 if case == 'group_of_12' else 3
  nk, nv = (torch.zeros(b, kv, d) for _ in range(2))
  cache_dtype, rows = torch.int8, d
  if case == 'scales_on_float_cache':
    cache_dtype = torch.float32
  elif case == 'int4_rows':
    cache_dtype = torch.uint8     # packed caches hold d / 2 rows
  ck, cv = (torch.zeros(b, kv, rows, length, dtype=cache_dtype)
            for _ in range(2))
  scales = [torch.zeros(b, kv, length) for _ in range(2)]
  if case == 'int8_no_scales':
    scales = [None, None]
  elif case == 'float16_scales':
    scales = [s.half() for s in scales]
  elif case == 'one_scale':
    scales[1] = None
  entry = (decode_attention.decode_attention_inplace if case == 'one_scale'
           else decode_attention._launch)
  with pytest.raises(ValueError):
    entry(q, nk, nv, ck, cv, torch.tensor(3, dtype=torch.int32), *scales)
  assert not calls and not any(ops.launch_counts().values())
