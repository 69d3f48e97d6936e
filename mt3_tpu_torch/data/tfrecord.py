"""TFRecord IO: native C++ reader with ctypes bindings + Python fallback
(copy of mt3_tpu/data/tfrecord.py).

The reference datasets are TFRecords of tf.train.Example protos read by
tf.data's native kernels; here native/tfrecord.cc provides the standalone
equivalent (CRC32C-validated record framing + Example wire-format parse).
The port compiles that unchanged source with the host C++ compiler at first
use (native/Makefile's flags) into build/native/, under a name keyed by a
hash of the source and the flags; each build writes a temporary file and
renames it, so concurrent processes never load a half-written library.
Where no compiler is found, the pure-Python reader runs; native_available()
and native_status() say which one is in use.  A compiler that fails on the
source raises its error: the Python reader is about 100x slower, so it is
never taken in place of a broken build.

Also includes a writer (Python) so datasets can be materialized and
round-tripped in tests.  Every function below the loader is the JAX
package's, and a test pins each to its original.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import struct
import subprocess
import threading
from typing import Dict, Iterator, Optional, Union

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
NATIVE_SOURCE = _REPO / 'native' / 'tfrecord.cc'
# <repo>/build/native unless MT3_TORCH_NATIVE_BUILD_DIR says otherwise.
BUILD_DIR = pathlib.Path(os.environ.get('MT3_TORCH_NATIVE_BUILD_DIR',
                                        _REPO / 'build' / 'native'))
# native/Makefile: CXXFLAGS ?= -O3 -fPIC -std=c++17 -Wall -Wextra, -shared.
CXX_FLAGS = ('-O3', '-fPIC', '-std=c++17', '-Wall', '-Wextra', '-shared')

_lib = None
_tried = False
_status = 'not loaded yet'
_lock = threading.Lock()


def library_path() -> pathlib.Path:
  digest = hashlib.sha256(NATIVE_SOURCE.read_bytes())
  digest.update(' '.join(CXX_FLAGS).encode())
  return BUILD_DIR / f'libmt3_native-{digest.hexdigest()[:16]}.so'


class NoCompilerError(RuntimeError):
  """No host C++ compiler to build the native reader with."""


def _build_library() -> pathlib.Path:
  """Compile native/tfrecord.cc unless its library is built; raises
  NoCompilerError when there is no compiler and RuntimeError when the
  build fails."""
  path = library_path()
  if path.exists():
    return path
  cxx = os.environ.get('CXX') or shutil.which('g++') or shutil.which('c++')
  if not cxx:
    raise NoCompilerError('no C++ compiler (g++, c++ or $CXX)')
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = path.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
  proc = subprocess.run([cxx, *CXX_FLAGS, '-o', str(tmp), str(NATIVE_SOURCE)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f'{cxx} failed on {NATIVE_SOURCE.name} (exit '
                       f'{proc.returncode}): {proc.stderr[-2000:]}')
  os.replace(tmp, path)
  return path


def _load_library():
  """The native library, built first if needed; None where there is no
  compiler to build it with (the Python reader runs then)."""
  global _lib, _tried, _status
  if _tried:
    return _lib
  with _lock:
    if _tried:
      return _lib
    try:
      path = _build_library()
    except NoCompilerError as e:
      _status = f'python (native reader unavailable: {e})'
      _tried = True
      return None
    lib = ctypes.CDLL(str(path))
    lib.tfx_open.restype = ctypes.c_void_p
    lib.tfx_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.tfx_next.restype = ctypes.c_long
    lib.tfx_next.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.tfx_close.argtypes = [ctypes.c_void_p]
    lib.tfx_parse_example.restype = ctypes.c_void_p
    lib.tfx_parse_example.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.tfx_free_example.argtypes = [ctypes.c_void_p]
    lib.tfx_feature_type.restype = ctypes.c_int
    lib.tfx_feature_type.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tfx_feature_len.restype = ctypes.c_long
    lib.tfx_feature_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tfx_feature_float.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float32)]
    lib.tfx_feature_int64.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64)]
    lib.tfx_feature_bytes_len.restype = ctypes.c_long
    lib.tfx_feature_bytes_len.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.tfx_feature_bytes.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.tfx_feature_bytes.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.tfx_feature_count.restype = ctypes.c_long
    lib.tfx_feature_count.argtypes = [ctypes.c_void_p]
    lib.tfx_feature_name.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
    _lib = lib
    _status = f'native ({path.name})'
    _tried = True
    return lib


def native_status() -> str:
  """Which reader runs: 'native (<library>)' or 'python (<why>)'."""
  _load_library()
  return _status


def native_available() -> bool:
  return _load_library() is not None


FeatureDict = Dict[str, Union[np.ndarray, list]]


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------
def read_records(path: str, check_crc: bool = True) -> Iterator[bytes]:
  """Yield raw record payloads from a TFRecord file."""
  lib = _load_library()
  if lib is not None:
    handle = lib.tfx_open(path.encode(), 1 if check_crc else 0)
    if not handle:
      raise IOError(f'cannot open {path}')
    try:
      ptr = ctypes.POINTER(ctypes.c_uint8)()
      while True:
        n = lib.tfx_next(handle, ctypes.byref(ptr))
        if n == 0:
          return
        if n < 0:
          raise IOError(f'corrupt TFRecord in {path}')
        yield ctypes.string_at(ptr, n)
    finally:
      lib.tfx_close(handle)
  else:
    yield from _read_records_py(path, check_crc)


def _masked_crc(data: bytes) -> int:
  import zlib
  del zlib
  crc = _crc32c(data)
  return (((crc >> 15) | (crc << 17)) + 0xa282ead8) & 0xFFFFFFFF


_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
  global _CRC_TABLE
  if _CRC_TABLE is None:
    table = []
    for i in range(256):
      c = i
      for _ in range(8):
        c = (0x82F63B78 ^ (c >> 1)) if c & 1 else (c >> 1)
      table.append(c)
    _CRC_TABLE = table
  crc = 0xFFFFFFFF
  for b in data:
    crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


def _read_records_py(path: str, check_crc: bool) -> Iterator[bytes]:
  with open(path, 'rb') as f:
    while True:
      header = f.read(12)
      if not header:
        return
      if len(header) != 12:
        raise IOError('truncated TFRecord header')
      length, length_crc = struct.unpack('<QI', header)
      if check_crc and _masked_crc(header[:8]) != length_crc:
        raise IOError('corrupt TFRecord length crc')
      data = f.read(length)
      data_crc = struct.unpack('<I', f.read(4))[0]
      if check_crc and _masked_crc(data) != data_crc:
        raise IOError('corrupt TFRecord data crc')
      yield data


def parse_example(record: bytes) -> FeatureDict:
  """Parse a serialized tf.train.Example into {name: array-or-bytes-list}."""
  lib = _load_library()
  if lib is not None:
    handle = lib.tfx_parse_example(record, len(record))
    if not handle:
      raise ValueError('malformed tf.train.Example')
    try:
      out: FeatureDict = {}
      count = lib.tfx_feature_count(handle)
      name_buf = ctypes.create_string_buffer(1024)
      for i in range(count):
        lib.tfx_feature_name(handle, i, name_buf, 1024)
        name = name_buf.value.decode()
        kind = lib.tfx_feature_type(handle, name.encode())
        n = lib.tfx_feature_len(handle, name.encode())
        if kind == 2:
          arr = np.empty(n, np.float32)
          lib.tfx_feature_float(handle, name.encode(), arr)
          out[name] = arr
        elif kind == 3:
          arr = np.empty(n, np.int64)
          lib.tfx_feature_int64(handle, name.encode(), arr)
          out[name] = arr
        elif kind == 1:
          values = []
          for j in range(n):
            blen = lib.tfx_feature_bytes_len(handle, name.encode(), j)
            ptr = lib.tfx_feature_bytes(handle, name.encode(), j)
            values.append(ctypes.string_at(ptr, blen))
          out[name] = values
      return out
    finally:
      lib.tfx_free_example(handle)
  return _parse_example_py(record)


def read_examples(path: str) -> Iterator[FeatureDict]:
  for record in read_records(path):
    yield parse_example(record)


# ---------------------------------------------------------------------------
# Pure-Python Example parser (fallback)
# ---------------------------------------------------------------------------
def _read_varint(data: bytes, pos: int):
  result = 0
  shift = 0
  while True:
    b = data[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _iter_fields(data: bytes):
  pos = 0
  while pos < len(data):
    tag, pos = _read_varint(data, pos)
    field, wire = tag >> 3, tag & 7
    if wire == 0:
      value, pos = _read_varint(data, pos)
    elif wire == 1:
      value = data[pos:pos + 8]
      pos += 8
    elif wire == 2:
      length, pos = _read_varint(data, pos)
      value = data[pos:pos + length]
      pos += length
    elif wire == 5:
      value = data[pos:pos + 4]
      pos += 4
    else:
      raise ValueError(f'bad wire type {wire}')
    yield field, wire, value


def _parse_example_py(record: bytes) -> FeatureDict:
  out: FeatureDict = {}
  for field, _, features in _iter_fields(record):
    if field != 1:
      continue
    for ffield, _, entry in _iter_fields(features):
      if ffield != 1:
        continue
      key = None
      feature = None
      for efield, _, value in _iter_fields(entry):
        if efield == 1:
          key = value.decode()
        elif efield == 2:
          feature = value
      if key is None or feature is None:
        continue
      for kind, wire, payload in _iter_fields(feature):
        values = list(_iter_fields(payload))
        if kind == 1:  # bytes list
          out[key] = [v for f, w, v in values if f == 1]
        elif kind == 2:  # float list
          floats = []
          for f, w, v in values:
            if f != 1:
              continue
            if w == 2:
              floats.append(np.frombuffer(v, np.float32))
            else:
              floats.append(np.frombuffer(v, np.float32, count=1))
          out[key] = (np.concatenate(floats) if floats
                      else np.zeros(0, np.float32))
        elif kind == 3:  # int64 list
          ints = []
          for f, w, v in values:
            if f != 1:
              continue
            if w == 2:
              pos = 0
              while pos < len(v):
                val, pos = _read_varint(v, pos)
                ints.append(np.int64(np.uint64(val)))
            else:
              ints.append(np.int64(np.uint64(v)))
          out[key] = np.array(ints, np.int64)
  return out


# ---------------------------------------------------------------------------
# Writing (Python)
# ---------------------------------------------------------------------------
def _varint(value: int) -> bytes:
  out = bytearray()
  while True:
    byte = value & 0x7F
    value >>= 7
    if value:
      out.append(byte | 0x80)
    else:
      out.append(byte)
      return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
  return _varint((number << 3) | wire) + payload


def _length_delimited(number: int, payload: bytes) -> bytes:
  return _field(number, 2, _varint(len(payload)) + payload)


def make_example(features: FeatureDict) -> bytes:
  """Serialize {name: value} into a tf.train.Example proto."""
  entries = b''
  for name, value in features.items():
    if isinstance(value, bytes):
      value = [value]
    if isinstance(value, (list, tuple)) and value and isinstance(
        value[0], bytes):
      payload = b''.join(_length_delimited(1, v) for v in value)
      feature = _length_delimited(1, payload)
    else:
      arr = np.asarray(value)
      if arr.dtype.kind == 'f':
        packed = arr.astype('<f4').tobytes()
        feature = _length_delimited(
            2, _length_delimited(1, packed))
      elif arr.dtype.kind in 'iu':
        packed = b''.join(
            _varint(int(np.uint64(np.int64(v)))) for v in arr.flat)
        feature = _length_delimited(
            3, _length_delimited(1, packed))
      else:
        raise ValueError(f'unsupported feature dtype for {name}')
    entry = _length_delimited(1, name.encode()) + _length_delimited(
        2, feature)
    entries += _length_delimited(1, entry)
  return _length_delimited(1, entries)


def write_records(path: str, records) -> None:
  with open(path, 'wb') as f:
    for record in records:
      header = struct.pack('<Q', len(record))
      f.write(header)
      f.write(struct.pack('<I', _masked_crc(header)))
      f.write(record)
      f.write(struct.pack('<I', _masked_crc(record)))
