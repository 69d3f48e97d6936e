"""`graph_step_share` read in the clip cells, where it moves
audio_s_per_s.clip: the same reading under a name of its own."""

from gpubench import spec

WRAP, read = spec.same_as('graph_step_share')
