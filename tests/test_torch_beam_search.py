"""Beam search in the PyTorch port against mt3_tpu.infer.beam_search.

* The JAX package's oracles (tests/test_beam_oracle.py) on the port: a
  Markov "model" patched into t5.init_decode_state / t5.decode_step makes
  brute force feasible, and with enough beams the search is exhaustive.
* Tokens identical to JAX's beam_search at tiny width on the same
  numpy-seeded encodings and parameters, scores within 1e-6 relative
  (float32 sums in another order), for float32 MHA caches and the
  production decode configuration.  The EOS column of the logits kernel is
  scaled in both trees so that beams finish at different steps (and some
  rows finish none, so the alive fallback runs too).
* Ties resolve lower index first, as lax.top_k resolves them.
* forbid_eos, the stop check every steps_per_iter steps, and the int4
  packed cache reshuffle against a gather of the unpacked codes.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt3_tpu.core import config as jax_config
from mt3_tpu.infer import beam_search as jax_bs
from mt3_tpu.infer import transcribe as jax_transcribe
from mt3_tpu.models import t5 as jax_t5
from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.core import config as torch_config
from mt3_tpu_torch.infer import beam_search as bs
from mt3_tpu_torch.infer import transcribe
from mt3_tpu_torch.models import layers, t5
from mt3_tpu_torch.ops import decode_attention
from tests.test_beam_oracle import brute_force_markov

torch.set_num_threads(2)

PAD, EOS = 0, 1
SCORE_RTOL = 1e-6


# ---------------------------------------------------------------------------
# Markov fake model (tests/test_beam_oracle.py:markov_model, on the port)
# ---------------------------------------------------------------------------
@pytest.fixture
def markov_model(monkeypatch):
  """t5 decode hooks replaced by a Markov chain over params['T'] (and
  params['T2'] after the first step).  The fake cache carries each row's
  own index, so the reshuffle runs on it."""

  def fake_init(params, config, encoded, max_decode_len):
    b = encoded.shape[0]
    tag = torch.arange(b, dtype=torch.float32)[None, :, None]
    return t5.DecodeState(
        cache=layers.KVCache(key=tag.clone(), value=tag.clone()),
        cross_k=torch.zeros(1), cross_v=torch.zeros(1),
        index=torch.zeros((), dtype=torch.int32))

  def fake_step(params, config, token, state):
    table = params['T']
    if 'T2' in params and int(state.index) > 0:
      table = params['T2']
    return (table[token.long()].clone(),
            dataclasses.replace(state, index=state.index + 1))

  monkeypatch.setattr(t5, 'init_decode_state', fake_init)
  monkeypatch.setattr(t5, 'decode_step', fake_step)


def _markov_search(tables, batch, max_len, num_beams, alpha=0.6):
  params = {'T': torch.from_numpy(tables[0])}
  if len(tables) > 1:
    params['T2'] = torch.from_numpy(tables[1])
  tokens, scores = bs.beam_search(params, None, torch.zeros(batch, 3, 4),
                                  max_len, num_beams=num_beams, alpha=alpha)
  return tokens.numpy(), scores.numpy()


def test_exhaustive_beam_matches_brute_force(markov_model):
  vocab, max_len, alpha = 5, 4, 0.6
  table = np.random.RandomState(42).randn(vocab, vocab).astype(
      np.float32) * 2.0
  tokens, scores = _markov_search([table], 2, max_len, 32, alpha)
  want_seq, want_score, _, _ = brute_force_markov([table], vocab, max_len,
                                                  alpha)
  for b in range(2):
    np.testing.assert_array_equal(tokens[b], want_seq)
    assert abs(float(scores[b]) - want_score) < 1e-3


def test_beam4_beats_greedy_on_trap(markov_model):
  vocab, max_len, alpha = 5, 4, 0.6
  t1 = np.full((vocab, vocab), -8.0, np.float32)
  t1[PAD, 2], t1[PAD, 3] = 2.0, 1.8
  t2 = np.zeros((vocab, vocab), np.float32)
  t2[3, :] = -6.0
  t2[3, EOS] = 6.0
  tokens, scores = _markov_search([t1, t2], 1, max_len, 4, alpha)
  want_seq, want_score, _, _ = brute_force_markov([t1, t2], vocab, max_len,
                                                  alpha)
  assert want_seq[0] == 3
  np.testing.assert_array_equal(tokens[0], want_seq)
  assert abs(float(scores[0]) - want_score) < 1e-3


def test_all_beams_finish_at_step_one(markov_model):
  vocab, max_len, alpha = 5, 6, 0.6
  table = np.full((vocab, vocab), -10.0, np.float32)
  table[:, EOS] = 10.0
  tokens, scores = _markov_search([table], 1, max_len, 4, alpha)
  want_seq, want_score, _, _ = brute_force_markov([table], vocab, max_len,
                                                  alpha)
  assert want_seq[0] == EOS
  np.testing.assert_array_equal(tokens[0], want_seq)
  assert abs(float(scores[0]) - want_score) < 1e-3


def test_nothing_finishes_alive_fallback(markov_model):
  vocab, max_len, alpha = 5, 3, 0.6
  table = np.random.RandomState(7).randn(vocab, vocab).astype(np.float32)
  table[:, EOS] = bs.NEG_INF
  tokens, scores = _markov_search([table], 1, max_len, 3, alpha)
  _, _, want_seq, want_score = brute_force_markov([table], vocab, max_len,
                                                  alpha)
  np.testing.assert_array_equal(tokens[0], want_seq)
  assert abs(float(scores[0]) - want_score) < 1e-3


# ---------------------------------------------------------------------------
# Ties
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('shape,k', (((3, 40), 8), ((2, 4, 24), 4),
                                     ((5, 12), 12)))
def test_top_k_orders_ties_as_lax(shape, k):
  """Whole-number values, as NEG_INF + a log prob rounds to: many ties."""
  x = np.random.RandomState(k).randint(-4, 3, size=shape).astype(
      np.float32) - 1e7
  want_values, want_indices = jax.lax.top_k(jnp.asarray(x), k)
  values, indices = bs.top_k(torch.from_numpy(x), k)
  np.testing.assert_array_equal(values.numpy(), np.asarray(want_values))
  np.testing.assert_array_equal(indices.numpy(), np.asarray(want_indices))


def test_tied_candidates_take_the_lower_index(markov_model, monkeypatch):
  """Tokens 2, 3 and 4 score alike from every state, and EOS never wins:
  every step is a three-way tie.  The lower index wins each one, so the
  best beam is all 2s, as in JAX's beam_search on the same chain."""
  vocab, max_len, beams = 5, 6, 2
  table = np.zeros((vocab, vocab), np.float32)
  table[:, EOS] = bs.NEG_INF
  tokens, scores = _markov_search([table], 2, max_len, beams)
  np.testing.assert_array_equal(tokens, np.full((2, max_len), 2))

  def jax_fake_init(params, config, encoded, max_decode_len):
    b = encoded.shape[0]
    return jax_t5.DecodeState(
        cache={'tag': jnp.arange(b, dtype=jnp.float32)[None, :]},
        cross_k=jnp.zeros((1,)), cross_v=jnp.zeros((1,)),
        index=jnp.zeros((), jnp.int32))

  monkeypatch.setattr(jax_t5, 'init_decode_state', jax_fake_init)
  monkeypatch.setattr(
      jax_t5, 'decode_step',
      lambda params, config, token, state: (
          params['T'][token], dataclasses.replace(state,
                                                  index=state.index + 1)))
  config = jax_config.ModelConfig(vocab_size=vocab, emb_dim=8, num_heads=2,
                                  num_encoder_layers=1, num_decoder_layers=1,
                                  head_dim=4, mlp_dim=8, input_depth=4,
                                  max_positions=16)
  want_tokens, want_scores = jax_bs.beam_search(
      {'T': jnp.asarray(table)}, config, jnp.zeros((2, 3, 4)),
      max_decode_len=max_len, num_beams=beams)
  np.testing.assert_array_equal(tokens, np.asarray(want_tokens))
  np.testing.assert_allclose(scores, np.asarray(want_scores),
                             rtol=SCORE_RTOL)


# ---------------------------------------------------------------------------
# The real model at tiny width against JAX's beam_search
# ---------------------------------------------------------------------------
PRODUCTION = dict(decode_kv_quantize=True, decode_kv_bits=4,
                  decode_cross_kv_quantize=True, decode_cache_carry='stacked',
                  num_kv_heads=1)
CONFIGS = {'mha': {}, 'production': PRODUCTION,
           'int8_gqa2': dict(decode_kv_quantize=True, num_kv_heads=2)}


def _tiny_models(overrides, eos_scale, seed=0):
  """JAX and port configs and trees; the logits kernel's EOS column is
  scaled by eos_scale in both, so that EOS wins at some steps."""
  jax_cfg = dataclasses.replace(jax_config.tiny_config().model, **overrides)
  torch_cfg = dataclasses.replace(torch_config.tiny_config().model,
                                  **overrides)
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(seed), jax_cfg)
  numpy_params = jax.tree_util.tree_map(np.array, jax_params)
  numpy_params['decoder']['logits'][:, EOS] *= eos_scale
  return (jax_cfg, numpy_params, torch_cfg,
          params_lib.from_numpy_tree(numpy_params))


# (config, EOS scale, steps per stop check): scale 1 leaves rows that never
# finish (alive fallback) beside one that finishes at step 2; 2 and 2.5
# finish rows at steps 2 to 6.
CASES = [('mha', 1.0, 1), ('mha', 2.5, 1), ('mha', 2.0, 8),
         ('production', 1.0, 16), ('production', 2.0, 1),
         ('int8_gqa2', 2.0, 4)]


@pytest.mark.parametrize('name,eos_scale,steps_per_iter', CASES,
                         ids=[f'{n}-eos{s}-every{k}' for n, s, k in CASES])
def test_beam_search_matches_jax(name, eos_scale, steps_per_iter):
  jax_cfg, numpy_params, torch_cfg, torch_params = _tiny_models(
      CONFIGS[name], eos_scale)
  encoded = np.random.RandomState(1).randn(4, 8, jax_cfg.emb_dim).astype(
      np.float32)
  want_tokens, want_scores = jax_bs.beam_search(
      numpy_params, jax_cfg, encoded, 32, num_beams=4)
  tokens, scores = bs.beam_search(torch_params, torch_cfg,
                                  torch.from_numpy(encoded), 32, num_beams=4,
                                  steps_per_iter=steps_per_iter)
  np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
  np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                             rtol=SCORE_RTOL)
  lengths = (tokens.numpy() > 0).sum(1)
  if eos_scale > 1.0:
    assert len(set(lengths)) > 1 and (tokens.numpy() == EOS).any(), lengths


def test_forbid_eos_runs_full_length():
  jax_cfg, numpy_params, torch_cfg, torch_params = _tiny_models({}, 2.5)
  encoded = np.random.RandomState(2).randn(2, 8, jax_cfg.emb_dim).astype(
      np.float32)
  want, _ = jax_bs.beam_search(numpy_params, jax_cfg, encoded, 12,
                               num_beams=3, forbid_eos=True)
  tokens, _ = bs.beam_search(torch_params, torch_cfg,
                             torch.from_numpy(encoded), 12, num_beams=3,
                             forbid_eos=True)
  tokens = tokens.numpy()
  assert not np.any(tokens == EOS) and not np.any(tokens == PAD)
  np.testing.assert_array_equal(tokens, np.asarray(want))


def test_real_model_beam_matches_brute_force():
  """tests/test_beam_oracle.py's tiny real T5 (vocab 5): beam 4 returns
  the best of every EOS-terminated sequence of length <= 3, scored by the
  JAX package's teacher-forced rescore, and JAX's own beam tokens."""
  from tests.test_beam_oracle import _score_sequences
  vocab, max_len, alpha = 5, 3, 0.6
  kwargs = dict(vocab_size=vocab, emb_dim=16, num_heads=2,
                num_encoder_layers=1, num_decoder_layers=1, head_dim=8,
                mlp_dim=16, dropout_rate=0.0, input_depth=8, max_positions=8)
  jax_cfg = jax_config.ModelConfig(**kwargs)
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(3), jax_cfg)
  encoder_input = np.random.RandomState(0).randn(1, 4, 8).astype(np.float32)
  encoded = np.asarray(jax_t5.encode(jax_params, jax_cfg, encoder_input))
  torch_params = params_lib.from_numpy_tree(
      jax.tree_util.tree_map(np.asarray, jax_params))
  tokens, _ = bs.beam_search(torch_params, torch_config.ModelConfig(**kwargs),
                             torch.from_numpy(encoded), max_len, num_beams=4,
                             alpha=alpha)
  candidates = [list(prefix) + [EOS] + [PAD] * (max_len - length)
                for length in range(1, max_len + 1)
                for prefix in itertools.product((2, 3, 4), repeat=length - 1)]
  scores = _score_sequences(jax_params, jax_cfg, encoder_input, candidates,
                            alpha)
  np.testing.assert_array_equal(tokens.numpy()[0],
                                candidates[int(np.argmax(scores))])
  want, _ = jax_bs.beam_search(jax_params, jax_cfg, encoded, max_len,
                               num_beams=4, alpha=alpha)
  np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The cache reshuffle
# ---------------------------------------------------------------------------
def test_int4_packed_reshuffle_equals_unpacked_gather():
  """Packed int4 rows move as whole bytes: unpacking after the reshuffle
  equals gathering the unpacked codes.  Scales move with them; positions
  past the live prefix stay as they were."""
  rng = np.random.RandomState(11)
  layers_, rows, kv, d, length, live = 2, 6, 1, 8, 10, 7
  codes = rng.randint(-8, 8, size=(layers_, rows, kv, d, length))
  packed = decode_attention.pack_int4(torch.from_numpy(codes).to(torch.int8))
  assert packed.shape == (layers_, rows, kv, d // 2, length)
  np.testing.assert_array_equal(decode_attention.unpack_int4(packed).numpy(),
                                codes)
  scales = torch.from_numpy(rng.rand(layers_, rows, kv, length).astype(
      np.float32))
  state = t5.DecodeState(
      cache=layers.KVCache(key=packed.clone(), value=packed.clone(),
                           key_scale=scales.clone(),
                           value_scale=scales.clone()),
      cross_k=torch.zeros(1), cross_v=torch.zeros(1),
      index=torch.tensor(live, dtype=torch.int32))
  storage = state.cache.key.data_ptr()
  index = torch.from_numpy(rng.randint(0, rows, size=rows))
  bs.reshuffle_cache(state, index, live)
  assert state.cache.key.data_ptr() == storage
  want = codes.copy()
  want[..., :live] = codes[:, index.numpy()][..., :live]
  for cache in (state.cache.key, state.cache.value):
    np.testing.assert_array_equal(decode_attention.unpack_int4(cache).numpy(),
                                  want)
  want_scales = scales.numpy().copy()
  want_scales[..., :live] = scales.numpy()[:, index.numpy()][..., :live]
  np.testing.assert_array_equal(state.cache.key_scale.numpy(), want_scales)


# ---------------------------------------------------------------------------
# Transcriber(num_beams=)
# ---------------------------------------------------------------------------
def test_transcriber_beam_tokens_match_jax():
  """One segment batch through log-mel, the encoder and beam search: the
  port's tokens and lengths (non-PAD counts) equal JAX's."""
  jax_cfg = jax_config.tiny_config()
  torch_cfg = torch_config.tiny_config()
  jax_params, _ = jax_t5.init_params(jax.random.PRNGKey(0), jax_cfg.model)
  numpy_params = jax.tree_util.tree_map(np.array, jax_params)
  numpy_params['decoder']['logits'][:, EOS] *= 2.5
  frames = (np.random.RandomState(3).randn(
      4, jax_cfg.run.inputs_length, jax_cfg.spectrogram.hop_width) * 0.3
            ).astype(np.float32)
  want_tokens, want_lengths = jax_transcribe._transcribe_batch(
      numpy_params, jax_cfg.model, jax_cfg.spectrogram, frames, 16, 0.0,
      jax.random.PRNGKey(0), num_beams=4)
  tokens, lengths = transcribe._transcribe_batch(
      params_lib.from_numpy_tree(numpy_params), torch_cfg.model,
      torch_cfg.spectrogram, torch.from_numpy(frames), 16, 0.0, None,
      num_beams=4)
  np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
  np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_lengths))
