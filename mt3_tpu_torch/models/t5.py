"""T5-style encoder-decoder over log-mel inputs (port of mt3_tpu/models/t5.py).

Pre-LN encoder layers over projected log-mel frames with fixed sinusoidal
positions, and a decoder with self + cross attention emitting event-token
logits in float32.  Per-layer weights stay stacked along a leading
`layers` axis, as in the JAX package; where JAX runs the stack under
lax.scan, the port runs a Python loop over layers.

Incremental decoding: cross-attention K/V are projected once per segment;
the self-attention cache [layers, b, heads, head_dim, len] is written one
column per step, in place (see layers.attention_decode_step).

Ported: init_params, encode, DecodeState / init_decode_state, decode_step
(the 'scan' carry).  Teacher-forced decode_train / forward and the
'stacked' carry wait for later slices (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core.config import ModelConfig
from mt3_tpu_torch.models import layers
from mt3_tpu_torch.models.layers import KVCache


def _dtype(config: ModelConfig):
  return torch.bfloat16 if config.dtype == 'bfloat16' else torch.float32


@functools.lru_cache(maxsize=None)
def _position_table(max_len: int, features: int,
                    device: torch.device) -> torch.Tensor:
  return torch.from_numpy(layers.sinusoidal_table(max_len, features)).to(
      device)


def init_params(config: ModelConfig,
                generator: Optional[torch.Generator] = None,
                device='cpu') -> params_lib.Tree:
  """Build the parameter tree (see params.init_params)."""
  return params_lib.init_params(config, generator, device)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------
def encode(params, config: ModelConfig,
           encoder_input: torch.Tensor) -> torch.Tensor:
  """[b, len, depth] continuous inputs -> [b, len, emb] encodings.

  Like the reference, the encoder attends to zero-padding (no input mask).
  """
  dtype = _dtype(config)
  length = encoder_input.shape[1]
  x = layers.dense(params['encoder']['input_proj'], encoder_input, dtype)
  pos = _position_table(config.max_positions, config.emb_dim,
                        encoder_input.device)
  x = (x + pos[:length][None, :, :].to(dtype)).to(dtype)
  stacked = params['encoder']['layers']
  for l in range(config.num_encoder_layers):
    lp = params_lib.layer(stacked, l)
    h = layers.rms_norm(lp['pre_attention_norm'], x, dtype=dtype)
    h = layers.attention(lp['attention'], h, h, bias=None,
                         num_heads=config.num_heads,
                         head_dim=config.head_dim, dtype=dtype,
                         num_kv_heads=config.num_kv_heads)
    x = x + h
    h = layers.rms_norm(lp['pre_mlp_norm'], x, dtype=dtype)
    x = x + layers.gated_mlp(lp['mlp'], h, config.mlp_activations, dtype)
  return layers.rms_norm(params['encoder']['norm'], x, dtype=dtype)


# ---------------------------------------------------------------------------
# Incremental decode
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DecodeState:
  """State carried between decode steps (caches are updated in place)."""
  cache: KVCache          # self-attention KV cache [L, b, h, d, max_len]
  cross_k: torch.Tensor   # [L, b, h, d, enc_len]
  cross_v: torch.Tensor   # [L, b, h, d, enc_len]
  index: torch.Tensor     # int32 scalar on the device: current position


def init_decode_state(params, config: ModelConfig, encoded: torch.Tensor,
                      max_decode_len: int) -> DecodeState:
  """Project encoder K/V once and allocate the self-attention cache."""
  if config.decode_cross_kv_quantize:
    raise NotImplementedError(layers._QUANTIZED)
  dtype = _dtype(config)
  b, enc_len, _ = encoded.shape
  stacked = params['decoder']['layers']['cross_attention']
  cross_k, cross_v = [], []
  for l in range(config.num_decoder_layers):
    lp = params_lib.layer(stacked, l)
    for name, out in (('key', cross_k), ('value', cross_v)):
      kv = layers.dense(lp[name], encoded.to(dtype), dtype)
      # [b, enc, kv, d] -> [b, kv, d, enc], the JAX package's layout.
      out.append(kv.reshape(b, enc_len, config.kv_heads,
                            config.head_dim).permute(0, 2, 3, 1))
  cache = layers.init_kv_cache(
      config.num_decoder_layers, b, config.kv_heads, config.head_dim,
      max_decode_len, dtype=dtype, device=encoded.device,
      quantized=config.decode_kv_quantize)
  return DecodeState(
      cache=cache, cross_k=torch.stack(cross_k).contiguous(),
      cross_v=torch.stack(cross_v).contiguous(),
      index=torch.zeros((), dtype=torch.int32, device=encoded.device))


def decode_step(params, config: ModelConfig, token: torch.Tensor,
                state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
  """One decode step: token [b] -> (float32 logits [b, vocab], new state).

  The returned state shares the caches of `state`, which this step has
  written at position state.index.
  """
  if config.decode_cache_carry != 'scan':
    raise NotImplementedError(
        "decode_cache_carry='stacked' is not ported yet (ROADMAP.md, "
        'modules to port: _decode_step_stacked)')
  dtype = _dtype(config)
  y = layers.embed(params['decoder']['token_embed'], token, dtype=dtype)
  pos = _position_table(config.max_positions, config.emb_dim, token.device)
  y = (y + pos.index_select(0, state.index.reshape(1).to(torch.long))[0]
       ).to(dtype)

  stacked = params['decoder']['layers']
  for l in range(config.num_decoder_layers):
    lp = params_lib.layer(stacked, l)
    h = layers.rms_norm(lp['pre_self_attention_norm'], y, dtype=dtype)
    h, _, _ = layers.attention_decode_step(
        lp['self_attention'], h, state.cache.key[l], state.cache.value[l],
        state.index, config.num_heads, config.head_dim, dtype=dtype,
        cache_update=config.decode_cache_update,
        attention_impl=config.decode_attention_impl,
        num_kv_heads=config.num_kv_heads)
    y = y + h
    h = layers.rms_norm(lp['pre_cross_attention_norm'], y, dtype=dtype)
    y = y + layers.cross_attention_decode_step(
        lp['cross_attention'], h, state.cross_k[l], state.cross_v[l],
        config.num_heads, config.head_dim, dtype=dtype,
        num_kv_heads=config.num_kv_heads)
    h = layers.rms_norm(lp['pre_mlp_norm'], y, dtype=dtype)
    y = y + layers.gated_mlp(lp['mlp'], h, config.mlp_activations, dtype)

  y = layers.rms_norm(params['decoder']['norm'], y, dtype=dtype)
  logits = layers.dense(params['decoder']['logits'], y, torch.float32)
  return logits, dataclasses.replace(state, index=state.index + 1)
