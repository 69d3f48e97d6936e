"""Serving-side postprocess cost: decoded tokens -> NoteSequence -> MIDI
(port of tools/postprocess_bench.py on the port's host modules, with its
flags and printed line).

The decode bench (mt3_tpu_torch.bench) stops at device tokens.  A
reference user's serving path continues on the host: vocab decode -> EOS
trim -> segment combine (decode_events state machine) ->
NoteSequence -> MIDI bytes.  This measures that tail on REAL token
densities (ground-truth targets of corpus clips — the same RLE streams a
converged model emits), in audio-seconds per host-second, directly
comparable with the device decode number.  Host CPU only.

Usage: python -m mt3_tpu_torch.tools.postprocess_bench --audio corpus/test
"""

import argparse
import time

import numpy as np


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--audio', default='corpus/test')
  parser.add_argument('--clips', type=int, default=12)
  parser.add_argument('--reps', type=int, default=3)
  args = parser.parse_args(argv)

  from mt3_tpu_torch.codec import note_events, run_length, vocabulary
  from mt3_tpu_torch.core import config as config_lib, midi_io
  from mt3_tpu_torch.data import datasets, pipeline
  from mt3_tpu_torch.infer import postprocess

  config = config_lib.mt3_config()
  run = config.run
  codec = vocabulary.build_codec(config.vocab)
  vocab = vocabulary.vocabulary_from_codec(codec)
  spec = config.spectrogram
  fps = spec.frames_per_second
  tie_token = codec.encode_event(note_events.Event('tie', 0))

  source = datasets.resolve_data_source(args.audio, spec,
                                        num_examples=args.clips)
  # Per-clip segment predictions carrying ground-truth RLE streams,
  # vocab-encoded and -decoded like real device output.
  preds_by_clip = []
  audio_seconds = 0.0
  for uid, ex in enumerate(source.examples()):
    feats = pipeline.tokenize_example(ex['sequence'], ex['audio'], spec,
                                      codec)
    n = len(feats['inputs'])
    preds = []
    for lo in range(0, n - run.inputs_length + 1, run.inputs_length):
      hi = lo + run.inputs_length
      seg = {
          'input_event_start_indices':
              feats['input_event_start_indices'][lo:hi],
          'input_event_end_indices':
              feats['input_event_end_indices'][lo:hi],
          'input_state_event_indices':
              feats['input_state_event_indices'][lo:hi],
          'state_events': feats['state_events'],
          'targets': feats['targets'],
      }
      seg = run_length.extract_target_sequence_with_indices(
          seg, state_events_end_token=tie_token)
      tokens = run_length.run_length_encode_shifts(seg['targets'], codec)
      tokens = run_length.remove_redundant_state_changes(
          tokens, codec, ['velocity', 'program'])
      ids = vocab.encode(list(tokens))  # device-output token space
      decoded = vocab.decode_array(np.asarray(ids, np.int32))
      preds.append(postprocess.postprocess_prediction(
          np.asarray(decoded), start_time=lo / fps, codec=codec,
          unique_id=uid))
      audio_seconds += run.inputs_length / fps
    if preds:
      preds_by_clip.append(preds)
  n_segments = sum(len(p) for p in preds_by_clip)
  if not n_segments:
    raise SystemExit(f'no usable segments under {args.audio!r}')

  t0 = time.perf_counter()
  midi_bytes = 0
  for _ in range(args.reps):
    midi_bytes = 0
    for preds in preds_by_clip:
      result = postprocess.event_predictions_to_ns(
          preds, codec=codec,
          encoding_spec=note_events.NoteEncodingWithTiesSpec)
      midi_bytes += len(midi_io.note_sequence_to_midi(result['est_ns']))
  dt = (time.perf_counter() - t0) / args.reps
  print(f'{len(preds_by_clip)} clips, {n_segments} segments, '
        f'{audio_seconds:.0f} audio-s: {dt * 1e3:.0f} ms '
        f'-> {audio_seconds / dt:.0f} audio-s/s host postprocess '
        f'({dt / n_segments * 1e3:.2f} ms/segment, {midi_bytes} MIDI bytes)',
        flush=True)


if __name__ == '__main__':
  main()
