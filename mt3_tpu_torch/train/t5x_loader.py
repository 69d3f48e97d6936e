"""Loader for published T5X checkpoints (port of mt3_tpu/train/t5x_loader.py).

T5X checkpoints are a `checkpoint` msgpack file (flax serialization)
whose large leaves are TensorStore spec dicts pointing at zarr arrays in
sibling directories.  This module reads that layout with numpy and the
standard library alone (no msgpack, flax or tensorstore), so published
weights load wherever the port runs:

  _msgpack_unpack  the msgpack subset flax writes, with flax's ext types
                   (ndarray, complex, numpy scalar) and its chunked-array
                   form; bfloat16 is widened to float32 by a 16-bit shift
  _read_zarr       zarr v2 arrays with gzip, zlib or no compression, the
                   chunks T5X writes; a blosc-compressed array goes through
                   tensorstore where it is installed, and raises naming the
                   compressor where it is not

The flat {path: array} dict then goes through
checkpoint.convert_t5x_param_dict, as in the JAX package.
"""

from __future__ import annotations

import gzip
import itertools
import json
import os
import struct
import zlib
from typing import Dict

import numpy as np


# ---------------------------------------------------------------------------
# msgpack (https://github.com/msgpack/msgpack/blob/master/spec.md)
# ---------------------------------------------------------------------------
_FIXED = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
          0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
# Type byte -> (kind, bytes of its length field).
_SIZED = {0xc4: ('bin', 1), 0xc5: ('bin', 2), 0xc6: ('bin', 4),
          0xc7: ('ext', 1), 0xc8: ('ext', 2), 0xc9: ('ext', 4),
          0xd9: ('str', 1), 0xda: ('str', 2), 0xdb: ('str', 4),
          0xdc: ('array', 2), 0xdd: ('array', 4),
          0xde: ('map', 2), 0xdf: ('map', 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_LENGTH = {1: '>B', 2: '>H', 4: '>I'}
_CONSTANTS = {0xc0: None, 0xc2: False, 0xc3: True}

# flax.serialization._MsgpackExtType
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _msgpack_unpack(data: bytes, raw: bool = False):
  """Decode one msgpack object; `raw` keeps str payloads as bytes."""
  value, end = _decode(memoryview(data), 0, raw)
  if end != len(data):
    raise ValueError(f'msgpack: {len(data) - end} trailing bytes')
  return value


def _decode(buf: memoryview, pos: int, raw: bool):
  """(object, position after it) for the object at buf[pos]."""
  tag = buf[pos]
  pos += 1
  if tag <= 0x7f:
    return tag, pos
  if tag >= 0xe0:
    return tag - 0x100, pos
  if tag <= 0x8f:
    return _decode_map(buf, pos, tag & 0x0f, raw)
  if tag <= 0x9f:
    return _decode_array(buf, pos, tag & 0x0f, raw)
  if tag <= 0xbf:
    return _decode_str(buf, pos, tag & 0x1f, raw)
  if tag in _CONSTANTS:
    return _CONSTANTS[tag], pos
  if tag in _FIXED:
    fmt = _FIXED[tag]
    return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
  if tag in _FIXEXT:
    return _decode_ext(buf, pos + 1, buf[pos], _FIXEXT[tag])
  if tag not in _SIZED:
    raise ValueError(f'msgpack: unknown type byte 0x{tag:02x}')
  kind, width = _SIZED[tag]
  n = struct.unpack_from(_LENGTH[width], buf, pos)[0]
  pos += width
  if kind == 'bin':
    return bytes(buf[pos:pos + n]), pos + n
  if kind == 'str':
    return _decode_str(buf, pos, n, raw)
  if kind == 'array':
    return _decode_array(buf, pos, n, raw)
  if kind == 'map':
    return _decode_map(buf, pos, n, raw)
  return _decode_ext(buf, pos + 1, buf[pos], n)


def _decode_str(buf, pos, n, raw):
  payload = bytes(buf[pos:pos + n])
  return (payload if raw else payload.decode('utf-8')), pos + n


def _decode_array(buf, pos, n, raw):
  items = []
  for _ in range(n):
    item, pos = _decode(buf, pos, raw)
    items.append(item)
  return items, pos


def _decode_map(buf, pos, n, raw):
  out = {}
  for _ in range(n):
    key, pos = _decode(buf, pos, raw)
    out[key], pos = _decode(buf, pos, raw)
  return out, pos


def _decode_ext(buf, pos, code, n):
  """flax's ext types (flax.serialization._msgpack_ext_unpack)."""
  code = code - 0x100 if code >= 0x80 else code
  payload = bytes(buf[pos:pos + n])
  if code == _EXT_NDARRAY:
    return _ndarray_from_bytes(payload), pos + n
  if code == _EXT_NPSCALAR:
    return _ndarray_from_bytes(payload)[()], pos + n
  if code == _EXT_COMPLEX:
    real, imag = _msgpack_unpack(payload)
    return complex(real, imag), pos + n
  raise ValueError(f'msgpack: ext type {code} is not one flax writes')


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
  """flax's ndarray encoding: msgpack (shape, dtype name, C-order bytes)."""
  shape, dtype_name, buffer = _msgpack_unpack(payload, raw=True)
  if dtype_name == b'bfloat16':
    return _widen_bfloat16(np.frombuffer(buffer, '<u2')).reshape(shape)
  return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(
      shape, order='C')


def _widen_bfloat16(bits: np.ndarray) -> np.ndarray:
  """bfloat16 bit patterns (uint16) -> the float32 values they hold."""
  return (bits.astype(np.uint32) << 16).view(np.float32)


def _unchunk_arrays(tree):
  """flax's '__msgpack_chunked_array__' dicts back into arrays."""
  if not isinstance(tree, dict):
    return tree
  if '__msgpack_chunked_array__' in tree:
    shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
    chunks = tree['chunks']
    return np.concatenate(
        [chunks[str(i)] for i in range(len(chunks))]).reshape(shape)
  return {k: _unchunk_arrays(v) for k, v in tree.items()}


def msgpack_restore(encoded: bytes):
  """flax.serialization.msgpack_restore without flax: a tree of dicts,
  lists, Python scalars and numpy arrays (bfloat16 arrays as float32)."""
  return _unchunk_arrays(_msgpack_unpack(encoded))


# ---------------------------------------------------------------------------
# zarr v2 (https://zarr-specs.readthedocs.io/en/latest/v2/v2.0.html)
# ---------------------------------------------------------------------------
_DECOMPRESS = {None: lambda b: b, 'gzip': gzip.decompress,
               'zlib': zlib.decompress}


def _zarr_dtype(name: str) -> np.dtype:
  """The stored dtype ('bfloat16' is stored as its uint16 bits)."""
  return np.dtype('<u2') if name == 'bfloat16' else np.dtype(name)


def _read_zarr(directory: str) -> np.ndarray:
  """A zarr v2 array of gzip, zlib or uncompressed C-order chunks; chunks
  absent from the directory hold fill_value.  bfloat16 comes back as
  float32."""
  with open(os.path.join(directory, '.zarray')) as f:
    meta = json.load(f)
  if meta.get('zarr_format') != 2 or meta.get('order', 'C') != 'C' or (
      meta.get('filters')):
    raise ValueError(f'{directory}: only zarr v2 arrays in C order without '
                     'filters are read')
  compressor = (meta.get('compressor') or {}).get('id')
  decompress = _DECOMPRESS[compressor]
  stored = _zarr_dtype(meta['dtype'])
  bf16 = meta['dtype'] == 'bfloat16'
  shape, chunks = tuple(meta['shape']), tuple(meta['chunks'])
  separator = meta.get('dimension_separator', '.')
  fill = meta.get('fill_value')
  out = np.full(shape, 0 if fill is None else fill,
                np.float32 if bf16 else stored)
  grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
  for index in itertools.product(*grid):
    name = separator.join(map(str, index)) if index else '0'
    chunk_path = os.path.join(directory, name)
    if not os.path.exists(chunk_path):
      continue
    with open(chunk_path, 'rb') as f:
      chunk = np.frombuffer(decompress(f.read()), stored).reshape(chunks)
    if bf16:
      chunk = _widen_bfloat16(chunk)
    region = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(index, chunks, shape))
    out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
  return out


def _zarr_directory(spec: dict) -> str:
  """The local directory of an anchored zarr spec (file kvstore)."""
  if spec.get('driver') != 'zarr':
    raise ValueError(f'only zarr TensorStore specs are read, got {spec}')
  kvstore = spec.get('kvstore')
  if isinstance(kvstore, dict):
    if kvstore.get('driver') != 'file':
      raise ValueError(f'only local (file) kvstores are read, got {kvstore}')
    return os.path.join(kvstore['path'], spec.get('path', ''))
  return spec['path']


# ---------------------------------------------------------------------------
# The checkpoint layout (as in the JAX package's loader).
# ---------------------------------------------------------------------------
def _flatten(tree: dict, prefix: str = '') -> Dict[str, object]:
  out = {}
  for key, value in tree.items():
    path = f'{prefix}/{key}' if prefix else key
    if isinstance(value, dict) and not _is_ts_spec(value):
      out.update(_flatten(value, path))
    else:
      out[path] = value
  return out


def _is_ts_spec(value) -> bool:
  return isinstance(value, dict) and 'driver' in value and (
      'kvstore' in value or 'path' in value)


def _find_target(state: dict) -> dict:
  """Locate the model-parameter ('target') subtree in a restored tree.

  Published T5X checkpoints wrap the parameters in an optimizer train
  state — typically {'version': .., 'optimizer': {'target': {..},
  'state': {'step', 'param_states': {..}}}} (t5x.checkpoints layout) —
  while minimal exports put 'target' at the top level.  Optimizer
  moments under 'state'/'param_states' are never touched (their
  TensorStore specs are not even opened).
  """
  if not isinstance(state, dict):
    raise ValueError(
        f'checkpoint msgpack root is {type(state).__name__}, expected a '
        'dict containing a "target" parameter subtree')
  if isinstance(state.get('target'), dict):
    return state['target']
  for wrapper in ('optimizer', 'checkpoint', 'train_state'):
    inner = state.get(wrapper)
    if isinstance(inner, dict):
      try:
        return _find_target(inner)
      except ValueError:
        pass
  raise ValueError(
      "no 'target' parameter subtree found in checkpoint msgpack; "
      f'top-level keys: {sorted(state)} (expected "target" directly or '
      'under "optimizer" as written by t5x.checkpoints)')


def load_t5x_checkpoint(checkpoint_dir: str,
                        restore_dtype=np.float32) -> Dict[str, np.ndarray]:
  """Read a T5X checkpoint directory -> flat {param_path: np.ndarray}.

  `checkpoint_dir` contains the msgpack file `checkpoint` plus
  `target.<dotted.param.path>/` TensorStore directories.  Only the
  'target' (model parameter) subtree is returned; optimizer state
  ('state'/'param_states', present in real training checkpoints) is
  skipped without being read.  bfloat16 leaves — inline or TensorStore —
  are upcast to `restore_dtype`.
  """
  msgpack_path = os.path.join(checkpoint_dir, 'checkpoint')
  with open(msgpack_path, 'rb') as f:
    state = msgpack_restore(f.read())

  target = _find_target(state)
  flat = _flatten(target)

  params = {}
  for path, value in flat.items():
    if _is_ts_spec(value):
      params[path] = _read_tensorstore(checkpoint_dir, path, value,
                                       restore_dtype)
    elif isinstance(value, np.ndarray):
      params[path] = value.astype(restore_dtype)
    elif np.isscalar(value):
      params[path] = np.asarray(value, restore_dtype)
  return params


def _read_tensorstore(checkpoint_dir: str, param_path: str, spec: dict,
                      restore_dtype) -> np.ndarray:
  spec = dict(spec)
  # T5X writes relative kvstore paths ('target.encoder.layers_0...');
  # anchor them at the checkpoint directory.
  kvstore = spec.get('kvstore')
  if isinstance(kvstore, dict):
    kvstore = dict(kvstore)
    path = kvstore.get('path', '')
    if path and not os.path.isabs(path) and not str(
        kvstore.get('driver', '')).startswith('gcs'):
      kvstore['path'] = os.path.join(checkpoint_dir, path)
      kvstore.setdefault('driver', 'file')
    spec['kvstore'] = kvstore
  elif 'path' in spec and not os.path.isabs(spec['path']):
    spec['path'] = os.path.join(checkpoint_dir, spec['path'])

  directory = _zarr_directory(spec)
  with open(os.path.join(directory, '.zarray')) as f:
    compressor = (json.load(f).get('compressor') or {}).get('id')
  if compressor in _DECOMPRESS:
    return _read_zarr(directory).astype(restore_dtype)
  from mt3_tpu_torch.train import checkpoint as ckpt
  try:
    return ckpt._read_tensorstore(spec).astype(restore_dtype)
  except ImportError as e:
    raise ImportError(
        f'{param_path}: zarr chunks compressed with {compressor!r} need '
        'tensorstore, which is not installed (gzip, zlib and uncompressed '
        'chunks are read without it)') from e


def load_t5x_params(checkpoint_dir: str, num_encoder_layers: int,
                    num_decoder_layers: int):
  """T5X checkpoint directory -> our model parameter pytree."""
  from mt3_tpu_torch.train import checkpoint as ckpt
  flat = load_t5x_checkpoint(checkpoint_dir)
  return ckpt.convert_t5x_param_dict(flat, num_encoder_layers,
                                     num_decoder_layers)
