"""The share of the model's decode steps that replayed a CUDA graph, in
%: the program's counter decode.graph_replays over decode.model_steps
(every t5.decode_step call), over the whole traced run, set-up's warm-up
included.  A decode state's first step runs eagerly and its second
captures the graph and replays it, so a 1024-step decode reads 1023 of
1024.  0 where the program counts steps and no replay; none where it
counts no steps (a program without the counters).  Moves audio_s_per_s."""

from gpubench import program_spans

program_spans.start()


def read(r):
  steps = program_spans.counter('decode.model_steps')
  if not steps:
    return None
  replays = program_spans.counter('decode.graph_replays') or 0
  return 100.0 * replays / steps
