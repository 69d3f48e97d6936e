"""The scalars of a TensorBoard event file, read back.

utils/tensorboard writes each scalar as an Event record (step in field 2,
a Summary in field 5 whose values carry their tag in field 1); this reads
them through data/tfrecord's framing and wire-format walker.
"""

from __future__ import annotations

from typing import List, Tuple

from mt3_tpu_torch.data import tfrecord


def scalar_events(path) -> List[Tuple[str, int]]:
  """(tag, step) of every scalar in the event file at `path`, in order."""
  out = []
  for record in tfrecord.read_records(str(path)):
    fields = {f: v for f, _, v in tfrecord._iter_fields(record)}
    if 5 in fields:
      for _, _, value in tfrecord._iter_fields(fields[5]):
        tag = dict((f, v) for f, _, v in tfrecord._iter_fields(value))[1]
        out.append((tag.decode(), fields[2]))
  return out
