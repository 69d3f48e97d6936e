"""Beam search decoding (port of mt3_tpu/infer/beam_search.py).

Length-normalized beam search with alive/finished beam bookkeeping and
early termination once no alive beam can improve on the worst finished one
(t5x.decoding.beam_search, the reference model's default decode_fn).  The
bookkeeping follows the JAX package's step for step; three things differ
in form, not in result:

* Ties.  lax.top_k puts the lower index first among equal values, and ties
  are common here (NEG_INF + a log prob rounds to whole numbers in float32;
  the finished merge is mostly NEG_INF), while torch.topk promises no
  order.  Every top-k is a stable descending sort, sliced.
* The caches.  The port's decode step writes its caches in place, so the
  beam reshuffle is an index_select along the batch*beam axis of every
  self-attention cache and scale tensor, copied back into the same
  storage, over the live prefix only (positions past the step are written
  before they are read).  Packed int4 codes move as whole bytes.  Cross K/V
  are identical across beams and stay.
* The stop check.  It is a device reduction read on the host, once every
  steps_per_iter steps.  Extra steps past the point where JAX stops change
  nothing: a new finished candidate scores at most the best alive log prob
  over a brevity penalty no larger than max_decode_len's, which is no
  better than the worst finished score, and a tie keeps the finished beam
  (it comes first in the merge).  Alive beams matter only where nothing
  finished, and then the check never stops the loop (it would take an
  alive score below NEG_INF times the penalty, that is NEG_INF-masked
  tokens, which a vocabulary larger than the beams never forces).

Brevity penalty follows GNMT: ((5 + len) / 6) ** alpha, alpha = 0.6.

Under a mesh each rank searches its rows with its parameter shards; the
logits are gathered whole on every model rank (t5.decode_step), so the
ranks of a model group take the same top-k and the same stop decision,
and no collective crosses 'data'.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mt3_tpu_torch.codec.vocabulary import EOS_ID, PAD_ID
from mt3_tpu_torch.core.config import ModelConfig
from mt3_tpu_torch.models import t5
from mt3_tpu_torch.parallel.partitioning import Mesh

NEG_INF = -1e7


def brevity_penalty(alpha: float, length) -> torch.Tensor:
  length = torch.as_tensor(length, dtype=torch.float32)
  return torch.pow((5.0 + length) / 6.0, alpha)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """lax.top_k along the last axis: the k largest, lower index first
  among equal values."""
  values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
  return values[..., :k], indices[..., :k]


def _gather_beams(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
  """x [batch, beams, ...] at indices [batch, n] along the beam axis."""
  batch = torch.arange(x.shape[0], device=x.device)[:, None]
  return x[batch, indices]


def reshuffle_cache(state: t5.DecodeState, flat_beam_index: torch.Tensor,
                    length: int) -> None:
  """Reorder the self-attention caches' batch*beam rows in place: row i
  takes row flat_beam_index[i], over the first `length` positions."""
  cache = state.cache
  for x in (cache.key, cache.value, cache.key_scale, cache.value_scale):
    if x is not None:
      live = x[..., :length]
      live.copy_(live.index_select(1, flat_beam_index))


def beam_search(params, config: ModelConfig, encoded: torch.Tensor,
                max_decode_len: int, num_beams: int = 4,
                alpha: float = 0.6, forbid_eos: bool = False,
                steps_per_iter: int = 1, mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Beam-search decode.

  Returns (tokens [batch, max_decode_len] int32 of the best beam, PAD
  after EOS, and its scores [batch] float32).  `forbid_eos` masks the EOS
  logit so that no beam finishes: the decode runs all max_decode_len steps.
  The stop check runs every steps_per_iter steps (clamped to a divisor of
  max_decode_len); the result does not depend on it.
  """
  batch = encoded.shape[0]
  device = encoded.device
  steps_per_iter = math.gcd(steps_per_iter, max_decode_len)

  encoded_rep = encoded.repeat_interleave(num_beams, dim=0)
  # The model functions take `mesh` only where there is one.
  on_mesh = {} if mesh is None else {'mesh': mesh}
  state = t5.init_decode_state(params, config, encoded_rep, max_decode_len,
                               **on_mesh)

  alive_log_probs = torch.full((batch, num_beams), NEG_INF,
                               dtype=torch.float32, device=device)
  alive_log_probs[:, 0] = 0.0
  alive_seqs = torch.full((batch, num_beams, max_decode_len), PAD_ID,
                          dtype=torch.int32, device=device)
  finished_seqs = alive_seqs.clone()
  finished_scores = torch.full((batch, num_beams), NEG_INF,
                               dtype=torch.float32, device=device)
  finished_flags = torch.zeros((batch, num_beams), dtype=torch.bool,
                               device=device)
  token = torch.zeros((batch * num_beams,), dtype=torch.int32, device=device)
  # penalties[i]: the brevity penalty of length i + 1.
  penalties = brevity_penalty(
      alpha, torch.arange(1, max_decode_len + 1)).to(device)
  max_penalty = penalties[-1]
  beam_base = (torch.arange(batch, device=device) * num_beams)[:, None]

  def improvement_possible() -> bool:
    best_alive = alive_log_probs[:, 0] / max_penalty
    worst_finished = torch.where(
        finished_flags, finished_scores,
        torch.full_like(finished_scores, NEG_INF)).min(dim=1).values
    return bool((best_alive > worst_finished).any())

  step = 0
  while step < max_decode_len and (step == 0 or improvement_possible()):
    for _ in range(steps_per_iter):
      logits, state = t5.decode_step(params, config, token, state, **on_mesh)
      logits[:, PAD_ID] = NEG_INF
      if forbid_eos:
        logits[:, EOS_ID] = NEG_INF
      log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
      vocab = log_probs.shape[-1]
      cand = alive_log_probs[:, :, None] + log_probs.view(batch, num_beams,
                                                          vocab)

      # 2*beams candidates so EOS picks never starve the alive set.
      topk_scores, topk_idx = top_k(cand.view(batch, num_beams * vocab),
                                    2 * num_beams)
      beam_idx = topk_idx // vocab
      token_idx = (topk_idx % vocab).to(torch.int32)
      seqs = _gather_beams(alive_seqs, beam_idx)
      seqs[:, :, step] = token_idx
      is_eos = token_idx == EOS_ID

      # Alive: the best beams among non-EOS candidates.
      alive_cand_scores = torch.where(
          is_eos, torch.full_like(topk_scores, NEG_INF), topk_scores)
      alive_log_probs, alive_sel = top_k(alive_cand_scores, num_beams)
      alive_seqs = _gather_beams(seqs, alive_sel)
      token = _gather_beams(token_idx, alive_sel).reshape(-1)
      alive_orig_beam = _gather_beams(beam_idx, alive_sel)

      # Finished: EOS candidates scored with the brevity penalty, merged
      # with the beams finished before.
      eos_scores = torch.where(
          is_eos, topk_scores / penalties[step],
          torch.full_like(topk_scores, NEG_INF))
      finished_scores, fin_sel = top_k(
          torch.cat([finished_scores, eos_scores], dim=1), num_beams)
      finished_seqs = _gather_beams(torch.cat([finished_seqs, seqs], dim=1),
                                    fin_sel)
      finished_flags = _gather_beams(
          torch.cat([finished_flags, is_eos], dim=1), fin_sel)

      # The caches follow the selected alive beams.
      reshuffle_cache(state, (beam_base + alive_orig_beam).reshape(-1),
                      step + 1)
      step += 1

  # If nothing finished for an example, fall back to the alive beams.
  none_finished = ~finished_flags.any(dim=1)
  final_seqs = torch.where(none_finished[:, None, None], alive_seqs,
                           finished_seqs)
  final_scores = torch.where(none_finished[:, None],
                             alive_log_probs / max_penalty, finished_scores)
  return final_seqs[:, 0], final_scores[:, 0]
