"""`decode_dispatch_ms_per_step` read in the clip cells, where it moves
audio_s_per_s.clip: the same reading under a name of its own."""

from gpubench import spec

WRAP, read = spec.same_as('decode_dispatch_ms_per_step')
