"""The T5 encoder-decoder of MT3, teacher-forced, in plain PyTorch.

Written from the published description (T5 v1.1 blocks as MT3 uses
them: pre-RMS-norm layers without biases, gated GELU MLP with the tanh
approximation, fixed sinusoidal positions added to the projected log-mel
frames and to the token embeddings, attention without a 1/sqrt(d) factor
because the query kernel carries it, float32 logits) and nothing else:
no kernel, cache or batching of the program.

`prec` picks the arithmetic: 'float32' (the reference; TF32 is off), or
'fp8' (the control), where every activation that a bf16 configuration
holds in bf16 is held in float8 e4m3 instead, each tensor under one
scale: the operands and results of the products, the attention logits
and weights, the norms' outputs, the residual stream, the dropout scale
and, in training, the gradients that flow back through them.  Norm
statistics, softmax, logits and the loss are computed in float32 in
both.

Parameters are the benchmark's tree (gpubench/weights.py): 2-D dense
kernels [in, out], per-layer leaves stacked on a leading axis.  Dropout,
where given, is a dict of boolean keep masks per site (reference/masks.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
  scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
  return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
  """Rounds to float8 e4m3 under one scale for the whole tensor, and the
  gradient that comes back the same way, as fp8 training rounds both the
  operands of a product and the gradients fed to its backward."""

  @staticmethod
  def forward(ctx, x):
    return _round_fp8(x)

  @staticmethod
  def backward(ctx, grad):
    return _round_fp8(grad)


def fp8(x: torch.Tensor) -> torch.Tensor:
  return _Fp8.apply(x)


def act(x, prec):
  """x as the activation dtype holds it."""
  if prec == 'fp8':
    return fp8(x)
  if prec != 'float32':
    raise ValueError(f'unknown precision {prec!r}')
  return x


def matmul(a, b, prec):
  return act(act(a, prec) @ act(b, prec), prec)


def einsum(spec, a, b, prec):
  return act(torch.einsum(spec, act(a, prec), act(b, prec)), prec)


@functools.lru_cache(maxsize=None)
def _positions(max_len, features):
  position = np.arange(max_len)[:, None]
  scale = -np.log(10000.0) / (features // 2 - 1)
  div = np.exp(np.arange(features // 2) * scale)
  table = np.zeros((max_len, features), np.float32)
  table[:, :features // 2] = np.sin(position * div)
  table[:, features // 2:] = np.cos(position * div)
  return table


def positions(length, features, device):
  return torch.from_numpy(_positions(2048, features)[:length]).to(device)


def rms_norm(x, scale, prec='float32'):
  return act(x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)
             * scale, prec)


def _drop(x, keep, rate, prec='float32'):
  if keep is None:
    return x
  keep_share = torch.tensor(1.0 - rate)
  if prec == 'fp8':
    keep_share = keep_share.to(torch.float8_e4m3fn).to(torch.float32)
  return act(x * keep.to(x.dtype) / keep_share.to(x.device), prec)


def attention(p, x_q, x_kv, cfg, prec, causal=False, keep=None, rate=0.0):
  """p: one layer's {'query', 'key', 'value', 'out'}; keep [b, h, 1, k]."""
  b, lq, _ = x_q.shape
  lk = x_kv.shape[1]
  h, d = cfg['num_heads'], cfg['head_dim']
  kv = cfg.get('num_kv_heads') or h
  q = matmul(x_q, p['query'], prec).reshape(b, lq, h, d)
  k = matmul(x_kv, p['key'], prec).reshape(b, lk, kv, d)
  v = matmul(x_kv, p['value'], prec).reshape(b, lk, kv, d)
  if kv != h:
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
  logits = einsum('bqhd,bkhd->bhqk', q, k, prec)
  if causal:
    mask = torch.ones(lq, lk, dtype=torch.bool, device=x_q.device).tril()
    logits = logits.masked_fill(~mask, float('-inf'))
  weights = act(torch.softmax(logits, dim=-1), prec)
  weights = _drop(weights, keep, rate, prec)
  out = einsum('bhqk,bkhd->bqhd', weights, v, prec).reshape(b, lq, h * d)
  return matmul(out, p['out'], prec)


def mlp(p, x, cfg, prec, keep=None, rate=0.0):
  inner = None
  for i, name_ in enumerate(cfg['mlp_activations']):
    name = 'wi' if len(cfg['mlp_activations']) == 1 else f'wi_{i}'
    a = matmul(x, p[name], prec)
    if name_ == 'gelu':
      a = act(F.gelu(a, approximate='tanh'), prec)
    elif name_ != 'linear':
      a = act(getattr(F, name_)(a), prec)
    inner = a if inner is None else act(inner * a, prec)
  return matmul(_drop(inner, keep, rate, prec), p['wo'], prec)


def _layer(stacked, l):
  if isinstance(stacked, dict):
    return {k: _layer(v, l) for k, v in stacked.items()}
  return stacked[l]


def _masks(drop, key):
  return None if drop is None else drop[key]


def encode(params, cfg, mel, prec='float32', drop=None):
  """[b, frames, mel] -> [b, frames, emb]."""
  rate = cfg['dropout_rate'] if drop is not None else 0.0
  enc = params['encoder']
  length = mel.shape[1]
  x = matmul(mel, enc['input_proj'], prec)
  x = act(x + positions(length, cfg['emb_dim'], x.device), prec)
  x = _drop(x, _masks(drop, 'enc.in'), rate, prec)
  for l in range(cfg['num_encoder_layers']):
    lp = _layer(enc['layers'], l)
    m = (lambda site: None) if drop is None else (
        lambda site, l=l: drop[f'enc.{l}.{site}'])
    h = rms_norm(x, lp['pre_attention_norm'], prec)
    h = attention(lp['attention'], h, h, cfg, prec, keep=m('attn'), rate=rate)
    x = act(x + _drop(h, m('res1'), rate, prec), prec)
    h = rms_norm(x, lp['pre_mlp_norm'], prec)
    h = mlp(lp['mlp'], h, cfg, prec, keep=m('mlp'), rate=rate)
    x = act(x + _drop(h, m('res2'), rate, prec), prec)
  x = rms_norm(x, enc['norm'], prec)
  return _drop(x, _masks(drop, 'enc.out'), rate, prec)


def decode(params, cfg, encoded, decoder_input, prec='float32', drop=None):
  """Teacher-forced decoder: [b, T] input ids -> float32 logits [b, T, V]."""
  rate = cfg['dropout_rate'] if drop is not None else 0.0
  dec = params['decoder']
  length = decoder_input.shape[1]
  y = dec['token_embed'][decoder_input.to(torch.long)]
  y = act(y + positions(length, cfg['emb_dim'], y.device), prec)
  y = _drop(y, _masks(drop, 'dec.in'), rate, prec)
  for l in range(cfg['num_decoder_layers']):
    lp = _layer(dec['layers'], l)
    m = (lambda site: None) if drop is None else (
        lambda site, l=l: drop[f'dec.{l}.{site}'])
    h = rms_norm(y, lp['pre_self_attention_norm'], prec)
    h = attention(lp['self_attention'], h, h, cfg, prec, causal=True,
                  keep=m('self'), rate=rate)
    y = act(y + _drop(h, m('res1'), rate, prec), prec)
    h = rms_norm(y, lp['pre_cross_attention_norm'], prec)
    h = attention(lp['cross_attention'], h, encoded, cfg, prec,
                  keep=m('cross'), rate=rate)
    y = act(y + _drop(h, m('res2'), rate, prec), prec)
    h = rms_norm(y, lp['pre_mlp_norm'], prec)
    h = mlp(lp['mlp'], h, cfg, prec, keep=m('mlp'), rate=rate)
    y = act(y + _drop(h, m('res3'), rate, prec), prec)
  y = rms_norm(y, dec['norm'], prec)
  y = _drop(y, _masks(drop, 'dec.out'), rate, prec)
  return y @ dec['logits']   # float32 logits, as the configuration states


def shift_right(targets: torch.Tensor) -> torch.Tensor:
  """Decoder inputs: BOS (0), then the targets but the last."""
  return torch.cat([torch.zeros_like(targets[:, :1]), targets[:, :-1]], dim=1)


def loss(logits, targets, weights, z_loss, label_smoothing):
  """(summed cross entropy + z-loss over weighted tokens, weight sum)."""
  vocab = logits.shape[-1]
  confidence = 1.0 - label_smoothing
  low = label_smoothing / (vocab - 1)
  constant = -(confidence * math.log(confidence + 1e-20)
               + (vocab - 1) * low * math.log(low + 1e-20))
  log_z = torch.logsumexp(logits, dim=-1)
  log_p = logits - log_z[..., None]
  one_hot = F.one_hot(targets.to(torch.long), vocab).to(torch.float32)
  soft = one_hot * confidence + (1.0 - one_hot) * low
  ce = -(soft * log_p).sum(-1) - constant
  per_token = (ce + z_loss * log_z * log_z) * weights
  return per_token.sum(), weights.sum()
