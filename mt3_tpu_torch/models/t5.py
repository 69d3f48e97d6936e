"""T5-style encoder-decoder over log-mel inputs (port of mt3_tpu/models/t5.py).

Pre-LN encoder layers over projected log-mel frames with fixed sinusoidal
positions, and a decoder with self + cross attention emitting event-token
logits in float32.  Per-layer weights stay stacked along a leading
`layers` axis, as in the JAX package; where JAX runs the stack under
lax.scan, the port runs a Python loop over layers.

Incremental decoding: cross-attention K/V are projected once per segment
(int8 with per-position scales under decode_cross_kv_quantize); the
self-attention cache [layers, b, kv_heads, head_dim, len] (float, int8 or
packed int4) is written one column per step, in place (see
layers.attention_decode_step).  The port's caches are written in place
under both carries, so decode_cache_carry 'scan' and 'stacked' compute the
same steps; both names are kept, with the JAX package's checks.

Training: encode(generator=) and decode_train / forward run the
teacher-forced model with dropout, the flash route of kernel C
(train_attention_impl='flash') and optional rematerialisation of each layer
(torch.utils.checkpoint).  Dropout masks come from per-layer generators on
the compute device, seeded from a host generator before the layer runs, so
a recomputed layer draws the same masks (the role of the JAX package's
per-layer key split).

Ported: init_params, encode, decode_train, forward, DecodeState /
init_decode_state and decode_step (which also takes the place of
_decode_step_stacked), with every decode mode of ModelConfig (quantized
caches, GQA, both carries).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
from torch.utils import checkpoint as checkpoint_lib

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
# Rematerialisation and dropout helpers
# ---------------------------------------------------------------------------
def _save_matmuls(ctx, op, *args, **kwargs):
  """'dots' policy: keep the products without batch dims (the dense
  projections, aten.mm), recompute the rest, as JAX's
  dots_with_no_batch_dims_saveable does."""
  del ctx, args, kwargs
  if op is torch.ops.aten.mm.default:
    return checkpoint_lib.CheckpointPolicy.MUST_SAVE
  return checkpoint_lib.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, config: ModelConfig):
  """Wrap a layer function in torch.utils.checkpoint per config.remat.

  'full' recomputes the whole layer in the backward pass; 'dots' keeps the
  dense products.  Layer functions build their dropout generators from a
  seed argument, so the recomputation draws the same masks.
  """
  if not config.remat:
    return fn
  policy = config.remat_policy
  if policy == 'dots':
    context_fn = functools.partial(
        checkpoint_lib.create_selective_checkpoint_contexts, _save_matmuls)
  elif policy == 'full':
    context_fn = checkpoint_lib.noop_context_fn
  else:
    raise ValueError(f'unknown remat_policy: {policy!r}')

  def remat_fn(*args):
    if not torch.is_grad_enabled():
      return fn(*args)
    return checkpoint_lib.checkpoint(fn, *args, use_reentrant=False,
                                     preserve_rng_state=False,
                                     context_fn=context_fn)
  return remat_fn


def _seeds(generator: Optional[torch.Generator], n: int) -> List[Optional[int]]:
  """n seeds drawn from a host (CPU) generator, or None without one."""
  if generator is None:
    return [None] * n
  return torch.randint(0, 2**62, (n,), generator=generator).tolist()


def _generator(seed: Optional[int], device) -> Optional[torch.Generator]:
  if seed is None:
    return None
  return torch.Generator(device=device).manual_seed(seed)


def _dropout(generator: Optional[torch.Generator], x: torch.Tensor,
             rate: float, broadcast_length: bool = True) -> torch.Tensor:
  """Dropout broadcast along the length dim (reference broadcast_dims=(-2,))."""
  if generator is None or rate == 0.0:
    return x
  shape = list(x.shape)
  if broadcast_length and len(shape) >= 2:
    shape[-2] = 1
  keep = layers.dropout_keep(generator, shape, rate, x.device)
  return torch.where(keep, x / torch.tensor(1.0 - rate, dtype=x.dtype),
                     torch.zeros((), dtype=x.dtype, device=x.device))


def _mlp_with_dropout(mlp_params, h, config: ModelConfig, dtype,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
  """Gated MLP with dropout on the gated inner activations."""
  inner = None
  for idx, act_name in enumerate(config.mlp_activations):
    name = 'wi' if len(config.mlp_activations) == 1 else f'wi_{idx}'
    a = layers._activation(act_name)(layers.dense(mlp_params[name], h, dtype))
    inner = a if inner is None else inner * a
  inner = _dropout(generator, inner, config.dropout_rate)
  return layers.dense(mlp_params['wo'], inner, dtype)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------
def encode(params, config: ModelConfig, encoder_input: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
  """[b, len, depth] continuous inputs -> [b, len, emb] encodings.

  Like the reference, the encoder attends to zero-padding (no input mask).
  With a host `generator`, dropout is live (training).
  """
  dtype = _dtype(config)
  device = encoder_input.device
  length = encoder_input.shape[1]
  rate = config.dropout_rate
  seeds = _seeds(generator, 2 + config.num_encoder_layers)
  flash_full = 'full' if config.train_attention_impl == 'flash' else None
  x = layers.dense(params['encoder']['input_proj'], encoder_input, dtype)
  pos = _position_table(config.max_positions, config.emb_dim, device)
  x = x + pos[:length][None, :, :].to(dtype)
  x = _dropout(_generator(seeds[0], device), x, rate).to(dtype)

  def encoder_layer(x, lp, seed):
    gen = _generator(seed, x.device)
    h = layers.rms_norm(lp['pre_attention_norm'], x, dtype=dtype)
    h = layers.attention(lp['attention'], h, h, bias=None,
                         num_heads=config.num_heads,
                         head_dim=config.head_dim, dtype=dtype,
                         dropout_generator=gen, dropout_rate=rate,
                         num_kv_heads=config.num_kv_heads,
                         flash_mode=flash_full)
    x = x + _dropout(gen, h, rate)
    h = layers.rms_norm(lp['pre_mlp_norm'], x, dtype=dtype)
    h = _mlp_with_dropout(lp['mlp'], h, config, dtype, gen)
    return x + _dropout(gen, h, rate)

  body = _maybe_remat(encoder_layer, config)
  stacked = params['encoder']['layers']
  for l in range(config.num_encoder_layers):
    x = body(x, params_lib.layer(stacked, l), seeds[2 + l])
  x = layers.rms_norm(params['encoder']['norm'], x, dtype=dtype)
  return _dropout(_generator(seeds[1], device), x, rate,
                  broadcast_length=False)


# ---------------------------------------------------------------------------
# Decoder (teacher-forced)
# ---------------------------------------------------------------------------
def decode_train(params, config: ModelConfig, encoded: torch.Tensor,
                 decoder_input_tokens: torch.Tensor,
                 decoder_target_tokens: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
  """Teacher-forced decode -> float32 logits [b, len, vocab].

  With train_attention_impl='flash' the self-attention takes the causal
  flash route and the cross-attention the unmasked one; their padding
  biases are then not used, so outputs differ from the einsum route only
  at padded target positions, which carry no loss weight.
  """
  dtype = _dtype(config)
  device = encoded.device
  length = decoder_input_tokens.shape[1]
  enc_len = encoded.shape[1]
  rate = config.dropout_rate
  seeds = _seeds(generator, 2 + config.num_decoder_layers)

  flash = config.train_attention_impl == 'flash'
  flash_causal = 'causal' if flash else None
  flash_full = 'full' if flash else None
  # Biases only where the einsum route will read them (layers.attention
  # ignores them on the flash route, taken when both lengths are >= 128).
  decoder_bias = cross_bias = None
  if not (flash and length >= 128):
    decoder_bias = layers.make_decoder_bias(decoder_target_tokens,
                                            torch.float32)
  if not (flash and min(length, enc_len) >= 128):
    # Query positions with non-padding targets attend to every encoder
    # position (network.py:330-333).
    nonpad = (decoder_target_tokens > 0).to(torch.float32)
    cross_bias = layers.make_attention_bias(
        nonpad, torch.ones((encoded.shape[0], enc_len), device=device),
        torch.float32)

  y = layers.embed(params['decoder']['token_embed'], decoder_input_tokens,
                   dtype=dtype)
  pos = _position_table(config.max_positions, config.emb_dim, device)
  y = y + pos[:length][None, :, :].to(dtype)
  y = _dropout(_generator(seeds[0], device), y, rate).to(dtype)
  encoded = encoded.to(dtype)

  def decoder_layer(y, lp, seed, encoded):
    gen = _generator(seed, y.device)
    h = layers.rms_norm(lp['pre_self_attention_norm'], y, dtype=dtype)
    h = layers.attention(lp['self_attention'], h, h, bias=decoder_bias,
                         num_heads=config.num_heads,
                         head_dim=config.head_dim, dtype=dtype,
                         dropout_generator=gen, dropout_rate=rate,
                         num_kv_heads=config.num_kv_heads,
                         flash_mode=flash_causal)
    y = y + _dropout(gen, h, rate)
    h = layers.rms_norm(lp['pre_cross_attention_norm'], y, dtype=dtype)
    h = layers.attention(lp['cross_attention'], h, encoded, bias=cross_bias,
                         num_heads=config.num_heads,
                         head_dim=config.head_dim, dtype=dtype,
                         dropout_generator=gen, dropout_rate=rate,
                         num_kv_heads=config.num_kv_heads,
                         flash_mode=flash_full)
    y = y + _dropout(gen, h, rate)
    h = layers.rms_norm(lp['pre_mlp_norm'], y, dtype=dtype)
    h = _mlp_with_dropout(lp['mlp'], h, config, dtype, gen)
    return y + _dropout(gen, h, rate)

  body = _maybe_remat(decoder_layer, config)
  stacked = params['decoder']['layers']
  for l in range(config.num_decoder_layers):
    y = body(y, params_lib.layer(stacked, l), seeds[2 + l], encoded)
  y = layers.rms_norm(params['decoder']['norm'], y, dtype=dtype)
  y = _dropout(_generator(seeds[1], device), y, rate)
  # Logits always in float32 (network.py:256-261).
  return layers.dense(params['decoder']['logits'], y, torch.float32)


def forward(params, config: ModelConfig, encoder_input: torch.Tensor,
            decoder_input_tokens: torch.Tensor,
            decoder_target_tokens: torch.Tensor,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
  """Full teacher-forced forward pass -> float32 logits [b, len, vocab].

  `generator` (a CPU torch.Generator) makes dropout live; the encoder and
  then the decoder draw their seeds from it.
  """
  encoded = encode(params, config, encoder_input, generator=generator)
  return decode_train(params, config, encoded, decoder_input_tokens,
                      decoder_target_tokens, generator=generator)


# ---------------------------------------------------------------------------
# Incremental decode
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DecodeState:
  """State carried between decode steps (caches are updated in place)."""
  cache: KVCache          # self-attention KV cache [L, b, kv, d, max_len]
  cross_k: torch.Tensor   # [L, b, kv, d, enc_len], int8 when quantized
  cross_v: torch.Tensor   # [L, b, kv, d, enc_len]
  index: torch.Tensor     # int32 scalar on the device: current position
  cross_k_scale: Optional[torch.Tensor] = None   # [L, b, kv, enc_len]
  cross_v_scale: Optional[torch.Tensor] = None


def init_decode_state(params, config: ModelConfig, encoded: torch.Tensor,
                      max_decode_len: int) -> DecodeState:
  """Project encoder K/V once and allocate the self-attention cache."""
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
  cross_k = torch.stack(cross_k).contiguous()
  cross_v = torch.stack(cross_v).contiguous()
  cross_k_scale = cross_v_scale = None
  if config.decode_cross_kv_quantize:
    cross_k, cross_k_scale = layers.quantize_kv_sequence(cross_k)
    cross_v, cross_v_scale = layers.quantize_kv_sequence(cross_v)
  cache = layers.init_kv_cache(
      config.num_decoder_layers, b, config.kv_heads, config.head_dim,
      max_decode_len, dtype=dtype, device=encoded.device,
      quantized=config.decode_kv_quantize, bits=config.decode_kv_bits)
  return DecodeState(
      cache=cache, cross_k=cross_k, cross_v=cross_v,
      index=torch.zeros((), dtype=torch.int32, device=encoded.device),
      cross_k_scale=cross_k_scale, cross_v_scale=cross_v_scale)


def _embed_step(params, config: ModelConfig, token: torch.Tensor,
                index: torch.Tensor, dtype) -> torch.Tensor:
  y = layers.embed(params['decoder']['token_embed'], token, dtype=dtype)
  pos = _position_table(config.max_positions, config.emb_dim, token.device)
  return (y + pos.index_select(0, index.reshape(1).to(torch.long))[0]
          ).to(dtype)


def _cross_and_mlp(lp, config: ModelConfig, y: torch.Tensor,
                   state: DecodeState, l: int, dtype) -> torch.Tensor:
  """A decoder layer after its self-attention: cross-attention, MLP."""
  scales = ((state.cross_k_scale[l], state.cross_v_scale[l])
            if state.cross_k_scale is not None else (None, None))
  h = layers.rms_norm(lp['pre_cross_attention_norm'], y, dtype=dtype)
  y = y + layers.cross_attention_decode_step(
      lp['cross_attention'], h, state.cross_k[l], state.cross_v[l],
      config.num_heads, config.head_dim, dtype=dtype,
      num_kv_heads=config.num_kv_heads, key_scale=scales[0],
      value_scale=scales[1])
  h = layers.rms_norm(lp['pre_mlp_norm'], y, dtype=dtype)
  return y + layers.gated_mlp(lp['mlp'], h, config.mlp_activations, dtype)


def _logits(params, y: torch.Tensor, dtype) -> torch.Tensor:
  y = layers.rms_norm(params['decoder']['norm'], y, dtype=dtype)
  return layers.dense(params['decoder']['logits'], y, torch.float32)


def decode_step(params, config: ModelConfig, token: torch.Tensor,
                state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
  """One decode step: token [b] -> (float32 logits [b, vocab], new state).

  The returned state shares the caches of `state`, which this step has
  written at position state.index.  decode_cache_carry='stacked'
  (t5._decode_step_stacked in the JAX package) runs the same steps, since
  the caches are written in place either way, after that function's checks.
  """
  if config.decode_cache_carry == 'stacked':
    if config.decode_cache_update != 'dus':
      raise ValueError("decode_cache_carry='stacked' requires "
                       "decode_cache_update='dus'")
    layers.check_stacked_impl(config.decode_attention_impl)
  dtype = _dtype(config)
  y = _embed_step(params, config, token, state.index, dtype)
  cache = state.cache
  stacked = params['decoder']['layers']
  for l in range(config.num_decoder_layers):
    lp = params_lib.layer(stacked, l)
    scales = ((cache.key_scale[l], cache.value_scale[l])
              if cache.quantized else (None, None))
    h = layers.rms_norm(lp['pre_self_attention_norm'], y, dtype=dtype)
    h = layers.attention_decode_step(
        lp['self_attention'], h, cache.key[l], cache.value[l],
        state.index, config.num_heads, config.head_dim, dtype=dtype,
        cache_update=config.decode_cache_update,
        attention_impl=config.decode_attention_impl,
        cache_k_scale=scales[0], cache_v_scale=scales[1],
        num_kv_heads=config.num_kv_heads)[0]
    y = _cross_and_mlp(lp, config, y + h, state, l, dtype)
  logits = _logits(params, y, dtype)
  return logits, dataclasses.replace(state, index=state.index + 1)
