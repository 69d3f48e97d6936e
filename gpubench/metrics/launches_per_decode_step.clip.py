"""`launches_per_decode_step` read in the clip cells, where it moves
audio_s_per_s.clip: the same reading under a name of its own."""

from gpubench import spec

WRAP, read = spec.same_as('launches_per_decode_step')
