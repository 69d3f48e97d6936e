"""Batched KV-cached autoregressive decoding (port of mt3_tpu/infer/decode.py).

The JAX package decodes in stages whose cache is 128, 256, ...,
max_decode_len slots long, so attention reads scale with the live prefix.
The port allocates the full length once and never grows the cache: the
decode-attention kernel reads only positions <= index, which gives the same
traffic without copying the cache at each bucket edge.

Steps run in a Python loop, one t5.decode_step call a step (on a CUDA
device without a mesh, a replay of the step's CUDA graph from the second
step on; the token's selection stays here, eager, and reads the step's
logits before the next step overwrites them).  Once per iteration of
steps_per_iter steps the host checks whether every sequence has emitted
EOS (one device sync) and stops if so.  Spans (utils/profiling): 'decode'
around a call, 'decode.step' around each step (t5.decode_step, whose span
is 'decode.model', and the token's selection), 'decode.done_check' around
each all-done check; counters decode.calls, decode.row_steps (rows x
steps run) and decode.checks.

Under a mesh (parallel/partitioning.Mesh) each rank decodes its rows with
its parameter shards.  No collective crosses 'data' inside a decode, so a
data rank stops when its own rows are done; the ranks of a model group
read the same gathered logits, so they pick the same tokens and stop at
the same step.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mt3_tpu_torch.codec.vocabulary import EOS_ID, PAD_ID
from mt3_tpu_torch.core.config import ModelConfig
from mt3_tpu_torch.models import t5
from mt3_tpu_torch.parallel.partitioning import Mesh
from mt3_tpu_torch.utils import profiling


def decode_tokens(params, config: ModelConfig, encoded: torch.Tensor,
                  max_decode_len: int,
                  temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  forbid_eos: bool = False,
                  steps_per_iter: int = 1,
                  mesh: Optional[Mesh] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Decode token sequences for a batch of encoded segments.

  Args:
    params: model parameters (torch tree on encoded's device).
    config: model config.
    encoded: [b, enc_len, emb] encoder outputs.
    max_decode_len: maximum tokens to emit per sequence.
    temperature: 0.0 for greedy argmax, >0 for temperature sampling.
    generator: torch.Generator on encoded's device for sampling; a fresh
        one seeded 0 when None.
    forbid_eos: benchmark mode, never emit EOS (forces full length).
    steps_per_iter: decode steps between two all-done checks; clamped to
        a divisor of max_decode_len so that no iteration overshoots.
    mesh: the mesh of `params`' shards, or None.

  Returns:
    (tokens [b, max_decode_len] int32 with PAD after EOS,
     lengths [b] int32: emitted tokens per sequence including EOS).
  """
  with profiling.span('decode'):
    b = encoded.shape[0]
    device = encoded.device
    if temperature > 0.0 and generator is None:
      generator = torch.Generator(device=device).manual_seed(0)
    steps_per_iter = math.gcd(steps_per_iter, max_decode_len)

    state = t5.init_decode_state(params, config, encoded, max_decode_len,
                                 mesh)
    buf = torch.full((b, max_decode_len), PAD_ID, dtype=torch.int32,
                     device=device)
    token = torch.zeros((b,), dtype=torch.int32, device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    pad = torch.full((b,), PAD_ID, dtype=torch.int32, device=device)

    step = checks = 0
    while step < max_decode_len:
      checks += 1
      with profiling.span('decode.done_check'):
        if bool(done.all()):
          break
      for _ in range(steps_per_iter):
        # Host clock only: the benchmark's trace hook switches profiler
        # sessions inside t5.decode_step, whose own span 'decode.model'
        # lies on the trace.
        with profiling.span('decode.step', annotate=False):
          logits, state = t5.decode_step(params, config, token, state, mesh)
          # Never emit PAD; it is reserved for positions after EOS.
          logits[:, PAD_ID] = -1e10
          if forbid_eos:
            logits[:, EOS_ID] = -1e10
          if temperature > 0.0:
            probs = torch.softmax(logits / temperature, dim=-1)
            next_token = torch.multinomial(probs, 1, generator=generator)[:, 0]
          else:
            next_token = torch.argmax(logits, dim=-1)
          next_token = torch.where(done, pad, next_token.to(torch.int32))
          buf[:, step] = next_token
          done = done | (next_token == EOS_ID)
          token = next_token
        step += 1
    profiling.count('decode.calls')
    profiling.count('decode.row_steps', b * step)
    profiling.count('decode.checks', checks)

    # Length = index of EOS + 1, or max_decode_len if no EOS.
    is_eos = buf == EOS_ID
    eos_pos = torch.argmax(is_eos.to(torch.int32), dim=-1)
    lengths = torch.where(is_eos.any(dim=-1), eos_pos + 1,
                          torch.full_like(eos_pos, max_decode_len))
    return buf, lengths.to(torch.int32)


def encode_and_decode(params, config: ModelConfig,
                      encoder_input: torch.Tensor, max_decode_len: int,
                      temperature: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      mesh: Optional[Mesh] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Convenience: encoder forward + token decode in one call."""
  encoded = t5.encode(params, config, encoder_input, mesh=mesh)
  return decode_tokens(params, config, encoded, max_decode_len,
                       temperature=temperature, generator=generator,
                       mesh=mesh)
