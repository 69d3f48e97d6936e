"""One-clip transcription: recordings transcribed one after another.

A closed loop of one caller.  Each unit takes the next clip of a pool of
`pool` clips of `clip_seconds` of piano-like audio (decaying harmonic
tones at pitches drawn from the seed, gpubench/clips.py) through
Transcriber.transcribe, as a user calls it, at the configuration's
infer_batch_size, and writes the notes as MIDI bytes (core.midi_io).
The unit's work is the clip's audio.  The tokens that decode.decode_tokens
returns are recorded, so that the check can hold them and the notes
against the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import clips, harness, program, serving, weights
from gpubench.reference import notes as ref_notes

MAIN_SESSION = 'decode'


def segments(audio, cfg):
  """The reference's cut of a clip: [segments, samples] float32 audio,
  and each segment's start time."""
  spec, length = cfg['spectrogram'], cfg['run']['inputs_length']
  hop = spec['hop_width']
  frames = -(-max(len(audio), 1) // hop)
  n = max(1, -(-frames // length))
  padded = np.zeros(n * length * hop, np.float32)
  padded[:len(audio)] = audio
  fps = spec['sample_rate'] / hop
  return (padded.reshape(n, length * hop),
          [i * length / fps for i in range(n)])


def setup(ctx):
  from mt3_tpu_torch.core import midi_io
  from mt3_tpu_torch.core.note_sequence import NoteSequence
  from mt3_tpu_torch.infer import decode, transcribe
  from mt3_tpu_torch.models import t5
  from mt3_tpu_torch.ops import spectrogram
  cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
  prog = program.config(cfg)
  if prog.run.infer_batch_size != traffic['infer_batch_size']:
    raise SystemExit('the configuration and the traffic disagree on '
                     'infer_batch_size')
  params = weights.make(cfg['model'], ctx.seed, device)
  ctx.mark('parameters')
  rng = np.random.default_rng(harness.stream_seed(ctx.seed, 2))
  pool = [clips.piano_clip(traffic['clip_seconds'], rng,
                           cfg['spectrogram']['sample_rate'])
          for _ in range(traffic['pool'])]
  ctx.mark('inputs')
  transcriber = transcribe.Transcriber(prog, params, device=device)
  program.load_kernels(ctx, ('logmel', 'decode_attention'))
  recorded = []
  decode_tokens = decode.decode_tokens

  def recording(*args, **kwargs):
    out = decode_tokens(*args, **kwargs)
    recorded.append(out[0])
    return out

  ctx.patch(decode, 'decode_tokens', recording)

  # Warm-up of the clip's shapes through the same layer functions: one
  # segment batch through log-mel and the encoder, the full-length caches,
  # a check's worth of decode steps, the host's token decode, stitching
  # and MIDI writing.
  batch = transcribe.audio_to_segments(pool[0], prog)[0]
  mc, length = prog.model, prog.run.targets_length
  with torch.inference_mode():
    frames = torch.from_numpy(batch.frames).to(device)
    mel = spectrogram.compute_logmel(spectrogram.flatten_frames(frames),
                                     prog.spectrogram)
    encoded = t5.encode(transcriber.params, mc, mel)
    state = t5.init_decode_state(transcriber.params, mc, encoded, length)
    token = torch.zeros((frames.shape[0],), dtype=torch.int32, device=device)
    for _ in range(mc.decode_steps_per_iter + 1):
      logits, state = t5.decode_step(transcriber.params, mc, token, state)
      token = torch.argmax(logits, dim=-1).to(torch.int32)
    bool((token == serving.EOS_ID).all())
    token.cpu()
    del frames, mel, encoded, state, logits
  warm = NoteSequence()
  warm.add_note(pitch=60, velocity=100, start_time=0.0, end_time=0.5)
  midi_io.note_sequence_to_midi(warm)
  ctx.mark('warm-up')
  serving.install_decode_trace(ctx, mc, frames=prog.run.inputs_length,
                               rows=traffic['infer_batch_size'])
  return dict(ctx=ctx, params=params, pool=pool, transcriber=transcriber,
              recorded=recorded, clips=[],
              midi=midi_io.note_sequence_to_midi)


def unit(state, i):
  ctx = state['ctx']
  clip = i % len(state['pool'])
  state['recorded'].clear()
  result = state['transcriber'].transcribe(state['pool'][clip])
  ns = result['est_ns']
  if ctx.spans is not None:
    with ctx.spans.timed('midi', i):
      midi = state['midi'](ns)
  else:
    midi = state['midi'](ns)
  tokens = torch.cat([t.cpu() for t in state['recorded']])
  lengths = serving.served_lengths(tokens)
  harness.log(f'clip {i} (pool {clip}): {len(ns.notes)} notes, {len(midi)} '
              f'MIDI bytes, tokens decoded per segment '
              f'{lengths.tolist()}')
  state['clips'].append(dict(
      clip=clip, tokens=tokens,
      notes=[(n.pitch, n.velocity, n.start_time, n.end_time, n.program,
              n.is_drum, n.instrument) for n in ns.notes],
      invalid=result['est_invalid_events'],
      dropped=result['est_dropped_events']))
  return ctx.traffic['clip_seconds']


def end_to_end(results, elapsed):
  return {'audio_s_per_s.clip': sum(results) / elapsed}


def _mismatch(got, want):
  return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


def check(state, results):
  """Clips sampled from the seed among those the window finished: the
  served tokens against the reference's logits, and the notes the program
  made of them against the reference's decoding of the same tokens."""
  ctx = state['ctx']
  cfg = ctx.config
  state['transcriber'] = None
  if ctx.cuda:
    torch.cuda.empty_cache()
  picked = serving.sample(ctx.seed, list(range(len(state['clips']))),
                          ctx.traffic['check_clips'])
  worst_gap, mismatch, failed = 0.0, 0, 0
  for k in picked:
    done = state['clips'][k]
    audio, starts = segments(state['pool'][done['clip']], cfg)
    tokens = done['tokens'][:len(starts)].to(ctx.device)
    audio = torch.from_numpy(audio).to(ctx.device)
    ref = serving.reference_logits(state['params'], cfg, audio, tokens)
    gap = float(serving.gaps(ref, tokens, False).max())
    want, invalid, dropped = ref_notes.decode(
        [(s, t.tolist()) for s, t in zip(starts, tokens.cpu())], cfg['vocab'])
    wrong = (_mismatch(done['notes'], want) + (invalid != done['invalid'])
             + (dropped != done['dropped']))
    worst_gap, mismatch = max(worst_gap, gap), mismatch + wrong
    failed += bool(wrong) or gap > ctx.limits.get('logit_gap', 0.0)
  checks = [harness.Check('logit_gap', worst_gap,
                          ctx.limits.get('logit_gap', 0.0)),
            harness.Check('note_mismatch', mismatch, 0)]
  return checks, len(state['clips']), failed
