"""The ('data', 'model') mesh on torch.distributed, and logical-axis partitioning.

Port of mt3_tpu/parallel/partitioning.py.  The JAX package places global
arrays on a jax.sharding.Mesh and lets XLA's SPMD partitioner insert every
collective.  The port runs one process per device: each process holds its
own shard of every parameter and its own rows of every batch, and the
collectives are explicit.

  Mesh        the mesh shape (data, model), this rank's coordinates, the
              'data', 'model' and 'world' process groups (on the device's
              backend, and on gloo for CPU tensors) and the rank's device.
              Ranks are laid out rank = data_index * model + model_index, as
              torch.distributed.device_mesh.init_device_mesh lays out a
              (data, model) mesh, so each model group is contiguous.
  make_mesh   a Mesh over the processes of the default group.
  logical_to_spec, DEFAULT_RULES   the JAX package's logical-axis rules.
  model_dims  for each parameter leaf, the dimension split over 'model'
              (or None): the rules, except that a K/V kernel whose heads do
              not divide by the model size stays replicated (head_layout).
  shard_params / replicated / shard_batch   this rank's parameters / rows.

Model-parallel layers (models/layers.py) take a mesh and use three
autograd functions on the model group, the pattern of Megatron-LM's
column- and row-parallel layers:

  copy_to_model      identity forward, all-reduce of the gradient backward
                     (before a column-parallel product);
  reduce_from_model  all-reduce forward, identity backward (after a
                     row-parallel product);
  gather_from_model  all-gather forward along a dimension, the rank's slice
                     of the gradient backward (the vocab-parallel logits).

Gathers are written as an all-reduce of a zero-filled buffer: exact (a
sum with zeros), and one code path for NCCL and for gloo on CPU or CUDA
tensors (two ranks sharing one card run gloo; all_reduce is the
collective every backend runs on every device).  A collective the backend
cannot run raises; nothing falls back.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from mt3_tpu_torch import params as params_lib
from mt3_tpu_torch.device import resolve_device

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

# Logical axis -> mesh axis.  Mirrors the t5x standard mapping: batch is
# data-parallel; the "wide" parameter axes (mlp, heads, vocab) are
# model-parallel; embed/kv/length/layers are replicated.
DEFAULT_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ('batch', DATA_AXIS),
    ('vocab', MODEL_AXIS),
    ('embed', None),
    ('mlp', MODEL_AXIS),
    ('heads', MODEL_AXIS),
    ('kv', None),
    ('joined_kv', MODEL_AXIS),
    ('length', None),
    ('layers', None),
)

_AXES = ('data', 'model', 'world')


@dataclasses.dataclass(eq=False)
class Mesh:
  """One rank's view of a (data, model) mesh of processes."""
  shape: Tuple[int, int]          # (data, model)
  data_index: int
  model_index: int
  device: torch.device
  groups: Dict[str, Any]          # axis -> group on the device's backend
  host_groups: Dict[str, Any]     # axis -> gloo group, for CPU tensors

  @property
  def data(self) -> int:
    return self.shape[0]

  @property
  def model(self) -> int:
    return self.shape[1]

  @property
  def rank(self) -> int:
    return self.data_index * self.model + self.model_index

  @property
  def is_chief(self) -> bool:
    return self.rank == 0

  def group(self, axis: str, x: torch.Tensor):
    """The process group of `axis` for a collective on `x`: the gloo group
    for a CPU tensor, the device backend's otherwise; None when the mesh
    has no process group (one process, torch.distributed not initialized)."""
    return (self.host_groups if x.device.type == 'cpu' else self.groups)[axis]


def _rank_device(device) -> torch.device:
  """The rank's device: `device`, and for CUDA without an index the card
  LOCAL_RANK (torchrun's) picks, modulo the cards present."""
  device = resolve_device(device)
  if device.type == 'cuda':
    if device.index is None:
      rank = dist.get_rank() if dist.is_initialized() else 0
      local = int(os.environ.get('LOCAL_RANK', rank))
      device = torch.device('cuda', local % torch.cuda.device_count())
    torch.cuda.set_device(device)
  return device


def _axis_groups(shape: Tuple[int, int], data_index: int, model_index: int,
                 backend: Optional[str]) -> Dict[str, Any]:
  """Every rank creates every group, in one order (new_group's contract)."""
  data, model = shape
  groups = {'world': (dist.group.WORLD if backend is None else
                      dist.new_group(list(range(data * model)),
                                     backend=backend))}
  for d in range(data):
    group = dist.new_group([d * model + m for m in range(model)],
                           backend=backend)
    if d == data_index:
      groups['model'] = group
  for m in range(model):
    group = dist.new_group([d * model + m for d in range(data)],
                           backend=backend)
    if m == model_index:
      groups['data'] = group
  return groups


def make_mesh(num_model_partitions: int = 1, device=None) -> Mesh:
  """A (world / num_model_partitions, num_model_partitions) mesh over the
  processes of the default group (a mesh of one without torch.distributed)."""
  initialized = dist.is_available() and dist.is_initialized()
  world = dist.get_world_size() if initialized else 1
  rank = dist.get_rank() if initialized else 0
  if num_model_partitions < 1 or world % num_model_partitions:
    raise ValueError(f'{world} processes not divisible by '
                     f'{num_model_partitions} model partitions')
  shape = (world // num_model_partitions, num_model_partitions)
  data_index, model_index = divmod(rank, num_model_partitions)
  device = _rank_device(device)
  if not initialized:
    groups = host_groups = dict.fromkeys(_AXES)
  else:
    groups = _axis_groups(shape, data_index, model_index, None)
    host_groups = (groups if dist.get_backend() == 'gloo' else
                   _axis_groups(shape, data_index, model_index, 'gloo'))
  return Mesh(shape, data_index, model_index, device, groups, host_groups)


# ---------------------------------------------------------------------------
# Logical axes
# ---------------------------------------------------------------------------
def logical_to_spec(axes: Tuple[str, ...],
                    rules=DEFAULT_RULES) -> Tuple[Optional[str], ...]:
  """Map a tuple of logical axis names to mesh axes (a PartitionSpec's
  entries)."""
  table = dict(rules)
  entries = []
  for name in axes:
    if name not in table:
      raise ValueError(f'no partitioning rule for logical axis {name!r}')
    entries.append(table[name])
  return tuple(entries)


@dataclasses.dataclass(frozen=True)
class HeadLayout:
  """The attention heads one model rank computes.

  heads: query heads; kv_heads: the K/V heads they read.  kv_columns is
  None where the K/V kernels hold exactly those heads (no mesh, or K/V
  heads split over 'model'); otherwise the kernels are replicated and
  kv_columns are the columns of the rank's K/V heads.
  """
  heads: int
  kv_heads: int
  kv_columns: Optional[slice] = None


def head_layout(num_heads: int, num_kv_heads: Optional[int], head_dim: int,
                mesh: Optional[Mesh]) -> HeadLayout:
  """Whole heads per model rank.  K/V heads that divide by the model size
  are split with their query heads; others stay replicated, and each rank
  reads the K/V heads its query heads use (one K/V head over 6 query heads
  at model 2: 3 query heads over the one K/V head on each rank)."""
  kv = num_kv_heads or num_heads
  if mesh is None:
    return HeadLayout(num_heads, kv)
  model = mesh.model
  if num_heads % model:
    raise ValueError(f'{num_heads} attention heads do not divide by '
                     f'{model} model partitions')
  heads = num_heads // model
  if kv % model == 0:
    return HeadLayout(heads, kv // model)
  group = num_heads // kv
  first = mesh.model_index * heads // group
  if heads % group == 0:
    count = heads // group
  elif group % heads == 0:
    count = 1
  else:
    raise ValueError(
        f'{heads} query heads per model rank split groups of {group} query '
        f'heads per K/V head ({num_heads} heads, {kv} K/V heads)')
  return HeadLayout(heads, count,
                    slice(first * head_dim, (first + count) * head_dim))


def model_dims(axes_tree, mesh: Mesh, config, rules=DEFAULT_RULES):
  """Tree of the dimension (negative) that each leaf splits over 'model',
  or None for a replicated leaf; `config` (a ModelConfig) decides whether
  the K/V kernels are split (head_layout)."""
  kv_replicated = head_layout(config.num_heads, config.num_kv_heads,
                              config.head_dim, mesh).kv_columns is not None

  def walk(node, name):
    if isinstance(node, dict):
      return {k: walk(v, k) for k, v in node.items()}
    spec = logical_to_spec(node, rules)
    dims = [i - len(spec) for i, axis in enumerate(spec)
            if axis == MODEL_AXIS]
    if len(dims) > 1:
      raise ValueError(f'{name}: more than one dimension over {MODEL_AXIS!r}')
    if not dims or (kv_replicated and name in ('key', 'value')):
      return None
    return dims[0]
  return walk(axes_tree, '')


def shard_params(params, axes_tree, mesh: Mesh, config, rules=DEFAULT_RULES):
  """This rank's shard of each leaf of a full tree, on the mesh's device."""
  local = params_lib.shard_tree(params, model_dims(axes_tree, mesh, config,
                                                   rules), mesh)
  return params_lib.to_device(local, mesh.device)


def replicated(params, mesh: Mesh):
  """The whole tree on the mesh's device (data parallelism only)."""
  return params_lib.to_device(params, mesh.device)


def shard_batch(batch, mesh: Optional[Mesh]):
  """This rank's rows of a global batch (a dict of arrays or tensors whose
  leading axis is the batch): the data_index-th of mesh.data equal blocks."""
  if mesh is None:
    return batch

  def rows(x):
    size = x.shape[0]
    if size % mesh.data:
      raise ValueError(f'batch of {size} rows does not divide by '
                       f'{mesh.data} data partitions')
    n = size // mesh.data
    return x[mesh.data_index * n:(mesh.data_index + 1) * n]
  return {k: rows(v) for k, v in batch.items()}


def local_block(x: torch.Tensor, mesh: Mesh,
                model_dim: Optional[int] = None) -> torch.Tensor:
  """This rank's block of a tensor drawn at the global shape: its rows of
  dim 0 and, with model_dim, its part of that dimension."""
  n = x.shape[0] // mesh.data
  x = x.narrow(0, mesh.data_index * n, n)
  if model_dim is not None:
    n = x.shape[model_dim] // mesh.model
    x = x.narrow(model_dim, mesh.model_index * n, n)
  return x


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------
def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
  """A reduced copy of `x` over the mesh axis's group."""
  group = mesh.group(axis, x)
  if group is None:
    return x
  out = x.clone(memory_format=torch.contiguous_format)
  dist.all_reduce(out, op=op, group=group)
  return out


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = -1) -> torch.Tensor:
  """Concatenate the 'data' or 'model' group's tensors along `dim`, in the
  order of the axis index, through an all-reduce of a zero-filled buffer."""
  group = mesh.group(axis, x)
  if group is None:
    return x
  count, index = ((mesh.data, mesh.data_index) if axis == DATA_AXIS else
                  (mesh.model, mesh.model_index))
  size = x.shape[dim]
  shape = list(x.shape)
  shape[dim] = size * count
  out = x.new_zeros(shape)
  out.narrow(dim, index * size, size).copy_(x)
  dist.all_reduce(out, group=group)
  return out


def data_sum(mesh: Optional[Mesh], *values: torch.Tensor):
  """Sum 0-d tensors over the data group (one all-reduce)."""
  if mesh is None:
    return values
  return tuple(all_reduce(torch.stack(values), mesh, DATA_AXIS).unbind())


def barrier(mesh: Optional[Mesh]) -> None:
  if mesh is not None and mesh.host_groups['world'] is not None:
    dist.barrier(group=mesh.host_groups['world'])


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
  """True on every rank if `flag` is true on any."""
  if mesh is None:
    return flag
  t = torch.tensor([int(flag)], dtype=torch.int64)
  return bool(all_reduce(t, mesh, 'world', op=dist.ReduceOp.MAX)[0])


class _CopyToModel(torch.autograd.Function):
  @staticmethod
  def forward(ctx, x, mesh):
    ctx.mesh = mesh
    return x.view_as(x)

  @staticmethod
  def backward(ctx, grad):
    return all_reduce(grad, ctx.mesh, MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
  @staticmethod
  def forward(ctx, x, mesh):
    return all_reduce(x, mesh, MODEL_AXIS)

  @staticmethod
  def backward(ctx, grad):
    return grad, None


class _GatherFromModel(torch.autograd.Function):
  @staticmethod
  def forward(ctx, x, mesh, dim):
    ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
    return all_gather(x, mesh, MODEL_AXIS, dim)

  @staticmethod
  def backward(ctx, grad):
    mesh = ctx.mesh
    return (grad.narrow(ctx.dim, mesh.model_index * ctx.size, ctx.size),
            None, None)


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
  """Identity; the gradient is summed over the model group."""
  return x if mesh is None else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
  """The sum of the model group's partial results; identity backward."""
  return x if mesh is None else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Optional[Mesh],
                      dim: int = -1) -> torch.Tensor:
  """The model group's blocks joined along `dim`; each rank's gradient is
  its block of the whole gradient."""
  return x if mesh is None else _GatherFromModel.apply(x, mesh, dim)
