"""Random parameters from the run's seed, in the layout of the port's tree.

One generator on the compute device draws everything in three calls: a
truncated normal (cut at 2 standard deviations) for every dense kernel,
a normal for the token embedding, and a normal for the norm scales.
Each dense kernel [in, out] is scaled to variance 1 / in (the query
kernel also by 1 / sqrt(head_dim), where MT3 keeps the attention scale);
norm scales are 1 + 0.1 N(0, 1), so that a scale read in the wrong place
shows.  Every leaf is float32, a view of one of three buffers.  The same
tensors go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

# The standard deviation of a unit normal cut at +-2: dividing by it gives
# the truncated draws the variance of the normal.
TRUNCATED_STD = 0.87962566103423978


def _shapes(cfg):
  """(dense leaves {path: (shape, scale)}, norm leaves {path: shape},
  embedding shape), paths dotted as in the port's parameter tree."""
  emb, h, d = cfg['emb_dim'], cfg['num_heads'], cfg['head_dim']
  kv = cfg.get('num_kv_heads') or h
  mlp, vocab = cfg['mlp_dim'], cfg['vocab_size']
  n_enc, n_dec = cfg['num_encoder_layers'], cfg['num_decoder_layers']
  dense, norms = {}, {}

  def attention(prefix, n):
    dense[f'{prefix}.query'] = ((n, emb, h * d), 1 / math.sqrt(d))
    dense[f'{prefix}.key'] = ((n, emb, kv * d), 1.0)
    dense[f'{prefix}.value'] = ((n, emb, kv * d), 1.0)
    dense[f'{prefix}.out'] = ((n, h * d, emb), 1.0)

  def gated_mlp(prefix, n):
    acts = cfg['mlp_activations']
    for i in range(len(acts)):
      name = 'wi' if len(acts) == 1 else f'wi_{i}'
      dense[f'{prefix}.{name}'] = ((n, emb, mlp), 1.0)
    dense[f'{prefix}.wo'] = ((n, mlp, emb), 1.0)

  dense['encoder.input_proj'] = ((cfg['input_depth'], emb), 1.0)
  attention('encoder.layers.attention', n_enc)
  gated_mlp('encoder.layers.mlp', n_enc)
  for name in ('pre_attention_norm', 'pre_mlp_norm'):
    norms[f'encoder.layers.{name}'] = (n_enc, emb)
  norms['encoder.norm'] = (emb,)
  attention('decoder.layers.self_attention', n_dec)
  attention('decoder.layers.cross_attention', n_dec)
  gated_mlp('decoder.layers.mlp', n_dec)
  for name in ('pre_self_attention_norm', 'pre_cross_attention_norm',
               'pre_mlp_norm'):
    norms[f'decoder.layers.{name}'] = (n_dec, emb)
  norms['decoder.norm'] = (emb,)
  dense['decoder.logits'] = ((emb, vocab), 1.0)
  return dense, norms, (vocab, emb)


def _put(tree, path, leaf):
  *parents, name = path.split('.')
  for key in parents:
    tree = tree.setdefault(key, {})
  tree[name] = leaf


def make(cfg, seed: int, device) -> dict:
  """The parameter tree of `cfg` drawn from `seed` on `device`."""
  dense, norms, embed_shape = _shapes(cfg)
  gen = torch.Generator(device=device).manual_seed(seed)
  total = sum(math.prod(shape) for shape, _ in dense.values())
  flat = torch.empty(total, dtype=torch.float32, device=device)
  torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
  embed = torch.randn(embed_shape, generator=gen, device=device)
  norm_total = sum(math.prod(shape) for shape in norms.values())
  norm_flat = 1.0 + 0.1 * torch.randn(norm_total, generator=gen,
                                      device=device)
  tree, start = {}, 0
  for path, (shape, scale) in dense.items():
    n = math.prod(shape)
    leaf = flat[start:start + n].view(shape)
    leaf.mul_(scale / math.sqrt(shape[-2]) / TRUNCATED_STD)
    _put(tree, path, leaf)
    start += n
  start = 0
  for path, shape in norms.items():
    n = math.prod(shape)
    _put(tree, path, norm_flat[start:start + n].view(shape))
    start += n
  _put(tree, 'decoder.token_embed', embed)
  return tree


def leaves(tree, prefix=''):
  """{dotted path: leaf} of a tree."""
  out = {}
  for key in sorted(tree):
    value = tree[key]
    if isinstance(value, dict):
      out.update(leaves(value, f'{prefix}{key}.'))
    else:
      out[f'{prefix}{key}'] = value
  return out
