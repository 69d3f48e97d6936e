"""Host milliseconds a clip spends after the device: the token decode
(GenericTokenVocabulary.decode_array), postprocess_prediction per segment,
event_predictions_to_ns (stitching into a NoteSequence) and the MIDI
writing, from the harness's spans, median over the clips that ran before
the profiler.  Moves audio_s_per_s.clip."""

import statistics

WRAP = {
    'mt3_tpu_torch.codec.vocabulary.GenericTokenVocabulary.decode_array':
        'host',
    'mt3_tpu_torch.infer.postprocess.postprocess_prediction': 'host',
    'mt3_tpu_torch.infer.postprocess.event_predictions_to_ns': 'host',
}
SPANS = tuple(WRAP) + ('midi',)


def read(r):
  if r.spans is None:
    return None
  per_clip = {}
  for name in SPANS:
    for record in r.spans.records.get(name, []):
      if r.spans.clean(record['unit']):
        per_clip[record['unit']] = per_clip.get(record['unit'], 0.0) + (
            record['host_s'])
  clips = [s for unit, s in per_clip.items()
           if any(rec['unit'] == unit for rec in r.spans.records.get('midi', []))]
  return statistics.median(clips) * 1e3 if clips else None
