"""mt3_tpu_torch.tools.cache_bw_bench against tools/cache_bw_bench.py and
a numpy reference, on the CPU.

The header's cache description and cache_bytes equal the JAX tool's for
each --dtype (int4 counts half a byte a code: the port's packed layout);
every pattern runs at --device cpu at a tiny size; and what each pattern
computes on a small cache set, with float32 arithmetic in place of bf16,
matches a float64 numpy reference of the operations its name describes
(kernel B's plain version for `einsum`) within 1e-5 (float32 sums of at
most a few hundred products).  The JAX tool is loaded from its file;
nothing in it is edited.
"""

import math
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt3_tpu_torch.tools import cache_bw_bench as cb
from tests.test_torch_quality_gates import load_jax_tool

torch.set_num_threads(2)

DTYPES = ['int4', 'int8', 'bfloat16']


@pytest.fixture(scope='module')
def jax_tool():
  return load_jax_tool('tools/cache_bw_bench.py')


@pytest.mark.parametrize('dtype', DTYPES)
def test_header_and_cache_bytes_are_the_jax_tools(jax_tool, monkeypatch,
                                                  capsys, dtype):
  argv = ['--dtype', dtype, '--batch', '8', '--len', '128']
  monkeypatch.setattr(sys, 'argv', ['cache_bw_bench.py'] + argv
                      + ['--patterns', 'none'])    # the header alone
  jax_tool.main()
  want = capsys.readouterr().out.strip()
  cb.main(argv + ['--patterns', 'einsum', '--iters', '1', '--device', 'cpu'])
  got = capsys.readouterr().out.strip().splitlines()[1]
  assert got.split(', iters')[0] == want.split(', iters')[0]
  shape = (cb.L, 8, cb.H, cb.D, 128)
  jdtype = {'int4': jnp.int4, 'int8': jnp.int8,
            'bfloat16': jnp.bfloat16}[dtype]
  assert cb.cache_bytes(shape, dtype) == jax_tool.cache_bytes(shape, jdtype)
  assert (cb.L, cb.H, cb.D) == (jax_tool.L, jax_tool.H, jax_tool.D)


@pytest.mark.parametrize('dtype', DTYPES)
def test_every_pattern_runs_on_the_cpu(capsys, dtype):
  cb.main(['--dtype', dtype, '--batch', '2', '--len', '16', '--iters', '2',
           '--device', 'cpu'])
  out = capsys.readouterr().out
  rows = re.findall(r'^(\w+): .* ([0-9.]+) ms/iter\s+([0-9.]+) GB/s$', out,
                    re.M)
  assert [r[0] for r in rows] == list(cb.PATTERNS)
  assert all(float(r[1]) > 0 for r in rows)


def test_unknown_pattern_and_no_cuda_raise():
  with pytest.raises(SystemExit, match='unknown patterns'):
    cb.main(['--patterns', 'sum,nope', '--device', 'cpu'])
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      cb.main([])


# ---------------------------------------------------------------------------
# What each pattern computes, against numpy in float64.
# ---------------------------------------------------------------------------
def deq(cache, dtype, dim):
  if dtype == 'bfloat16':
    return cache.float().numpy().astype(np.float64)
  x = cache.numpy()
  if dtype == 'int4':
    low = ((x & 15) ^ 8).astype(np.int64) - 8
    high = x.view(np.int8).astype(np.int64) >> 4
    dim = dim % x.ndim
    x = np.stack([low, high], axis=dim + 1)
    x = x.reshape(x.shape[:dim] + (-1,) + x.shape[dim + 2:])
  return x.astype(np.float64)


def softmax(x):
  e = np.exp(x - x.max(axis=-1, keepdims=True))
  return e / e.sum(axis=-1, keepdims=True)


def attend(q, k, v, ks=None, vs=None, mask=None, d_minor=False):
  spec = 'bhld' if d_minor else 'bhdl'
  logits = np.einsum(f'bhd,{spec}->bhl', q, k)
  if ks is not None:
    logits = logits * ks
  if mask is not None:
    logits = np.where(mask, logits, -1e9)
  w = softmax(logits)
  if vs is not None:
    w = w * vs
  return np.einsum(f'bhl,{spec}->bhd', w, v)


def gelu(x):
  return 0.5 * x * (1 + np.vectorize(math.erf)(x / math.sqrt(2)))


def reference(name, c, dtype, i):
  """What pattern `name` computes on set c (as it stands after the call,
  for the patterns that write), in float64."""
  f64 = lambda t: t.double().numpy()
  d_minor = name == 'layout_d'
  k, v = deq(c['k'], dtype, -1 if d_minor else -2), deq(
      c['v'], dtype, -1 if d_minor else -2)
  ks, vs, q = f64(c['ks']), f64(c['vs']), f64(c['q'])
  layers, length = k.shape[0], k.shape[-2 if d_minor else -1]
  if name == 'sum':
    return k.sum() + v.sum()
  if name == 'batched':
    logits = np.einsum('bhd,Lbhdl->Lbhl', q, k)
    out = np.einsum('Lbhl,Lbhdl->Lbhd', softmax(logits), v)
    return out.mean(axis=0) + q * 1e-6
  mask = (np.arange(length) < length // 2 + i)[None, None, :]
  out = q
  for l in range(layers):
    if name in ('layout_d', 'wide'):
      out = attend(out, k[l], v[l], d_minor=d_minor)
      continue
    scaled = name != 'einsum' or dtype != 'bfloat16'
    out = attend(out, k[l], v[l], ks[l] if scaled else None,
                 vs[l] if scaled else None,
                 mask if name == 'masked' else None)
    if name == 'interleaved':
      b, h, d = out.shape
      out = (gelu(out.reshape(b, h * d) @ f64(c['wi'])) @ f64(
          c['wo'])).reshape(b, h, d)
  return out


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', cb.PATTERNS)
def test_each_pattern_computes_its_reference(dtype, name):
  i = 3
  d_minor = name == 'layout_d'
  shape = (3, 2, cb.H, 24, cb.D) if d_minor else (3, 2, cb.H, cb.D, 24)
  gen = torch.Generator().manual_seed(7)
  c = cb.make_set(shape, dtype, gen, torch.device('cpu'), torch.float32,
                  d_minor)
  fn = {'sum': lambda: cb.sum_fn(c, dtype, torch.float32),
        'scaled': lambda: cb.scaled_fn(c, dtype, torch.float32),
        'einsum': lambda: cb.einsum_fn(c, dtype, torch.float32),
        'batched': lambda: cb.batched_fn(c, dtype, torch.float32),
        'layout_d': lambda: cb.plain_fn(c, dtype, torch.float32, True),
        'wide': lambda: cb.plain_fn(c, dtype, torch.float32),
        'masked': lambda: cb.masked_fn(c, dtype, torch.float32,
                                       shape[-1] // 2 + i),
        'written': lambda: cb.written_fn(c, dtype, torch.float32, i),
        'interleaved': lambda: cb.interleaved_fn(c, dtype, torch.float32),
        }[name]
  got = fn()
  want = reference(name, c, dtype, i)
  got = got.double().numpy()
  np.testing.assert_allclose(got, want, rtol=1e-5,
                             atol=1e-5 * max(1.0, np.abs(want).max()))
  if name == 'written':
    assert torch.equal(c['k'][:, ..., i], c['col'].expand_as(c['k'][:, ..., i]))
