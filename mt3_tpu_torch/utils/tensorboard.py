"""Minimal TensorBoard event-file writer (pure Python) (copy of mt3_tpu/utils/tensorboard.py).

The reference logs scalars/metrics through seqio's TensorBoard logger
(gin/train.gin:91-97).  This writer emits standard
`events.out.tfevents.*` files readable by TensorBoard, using the same
record framing as TFRecord (length + masked CRC32C, reused from
mt3_tpu/data/tfrecord.py) and hand-encoded Event/Summary protos:

  Event { double wall_time = 1; int64 step = 2; Summary summary = 5; }
  Summary { repeated Value value = 1; }
  Value { string tag = 1; float simple_value = 2; }
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Mapping, Optional

from mt3_tpu_torch.data.tfrecord import _masked_crc, _varint


def _field(number: int, wire: int, payload: bytes) -> bytes:
  return _varint((number << 3) | wire) + payload


def _double_field(number: int, value: float) -> bytes:
  return _field(number, 1, struct.pack('<d', value))


def _float_field(number: int, value: float) -> bytes:
  return _field(number, 5, struct.pack('<f', value))


def _varint_field(number: int, value: int) -> bytes:
  return _field(number, 0, _varint(value))


def _bytes_field(number: int, payload: bytes) -> bytes:
  return _field(number, 2, _varint(len(payload)) + payload)


def _event(wall_time: float, step: Optional[int] = None,
           summary: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
  out = _double_field(1, wall_time)
  if step is not None:
    out += _varint_field(2, step)
  if file_version is not None:
    out += _bytes_field(3, file_version.encode())
  if summary is not None:
    out += _bytes_field(5, summary)
  return out


class SummaryWriter:
  """Append scalar summaries to a TensorBoard event file."""

  def __init__(self, log_dir: str):
    os.makedirs(log_dir, exist_ok=True)
    name = (f'events.out.tfevents.{int(time.time())}.'
            f'{socket.gethostname()}')
    self.path = os.path.join(log_dir, name)
    self._file = open(self.path, 'ab')
    self._write(_event(time.time(), file_version='brain.Event:2'))

  def _write(self, record: bytes) -> None:
    header = struct.pack('<Q', len(record))
    self._file.write(header)
    self._file.write(struct.pack('<I', _masked_crc(header)))
    self._file.write(record)
    self._file.write(struct.pack('<I', _masked_crc(record)))
    self._file.flush()

  def add_scalar(self, tag: str, value: float, step: int) -> None:
    value_msg = _bytes_field(1, tag.encode()) + _float_field(2,
                                                             float(value))
    summary = _bytes_field(1, value_msg)
    self._write(_event(time.time(), step=step, summary=summary))

  def add_scalars(self, scalars: Mapping[str, float], step: int) -> None:
    for tag, value in scalars.items():
      self.add_scalar(tag, value, step)

  def close(self) -> None:
    self._file.close()
