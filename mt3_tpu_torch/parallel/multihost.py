"""Multi-process and multi-node mesh construction (port of
mt3_tpu/parallel/multihost.py).

Call `initialize()` once per process before building a mesh, then
`make_multihost_mesh()`.  One process per device: under torchrun the
arguments come from its environment (MASTER_ADDR / MASTER_PORT, RANK,
WORLD_SIZE, LOCAL_WORLD_SIZE).  A single process needs neither call:
partitioning.make_mesh builds a mesh of one.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from mt3_tpu_torch.parallel import partitioning

# A collective that waits longer than this raises instead of hanging.
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: datetime.timedelta = TIMEOUT) -> None:
  """torch.distributed.init_process_group; a no-op for one process.

  coordinator_address: 'host:port' (a TCP store), a URL ('tcp://...',
  'file://...'), or None for torchrun's environment (env://).
  num_processes / process_id default to WORLD_SIZE / RANK.  backend:
  'nccl' by default where CUDA is available, else 'gloo'; pass 'gloo' for
  several ranks on one card, which NCCL refuses, or for CPU ranks.
  """
  if num_processes is None:
    num_processes = int(os.environ.get('WORLD_SIZE', '1'))
  if num_processes <= 1:
    return
  if process_id is None:
    process_id = int(os.environ['RANK'])
  if coordinator_address is None:
    init_method = 'env://'
  elif '://' in coordinator_address:
    init_method = coordinator_address
  else:
    init_method = f'tcp://{coordinator_address}'
  if backend is None:
    backend = 'nccl' if torch.cuda.is_available() else 'gloo'
  dist.init_process_group(backend, init_method=init_method,
                          world_size=num_processes, rank=process_id,
                          timeout=timeout)


def shutdown() -> None:
  """Wait for every process, then destroy the process groups."""
  if dist.is_initialized():
    dist.barrier()
    dist.destroy_process_group()


def check_hybrid(world: int, node_size: int, num_model_partitions: int,
                 dcn_data_parallelism: int) -> None:
  """Raise ValueError unless `world` processes, node_size to a node, form
  dcn_data_parallelism nodes whose every model group lies inside one."""
  if node_size < 1 or world % node_size:
    raise ValueError(f'{world} processes do not fill nodes of {node_size}')
  nodes = world // node_size
  if nodes != dcn_data_parallelism:
    # A data axis that does not follow the node boundaries would mix
    # intra- and inter-node links in one model group's collectives.
    raise ValueError(f'dcn_data_parallelism={dcn_data_parallelism} does not '
                     f'match the {nodes} nodes of {node_size} processes')
  if node_size % num_model_partitions:
    raise ValueError(f'model groups of {num_model_partitions} processes cut '
                     f'across nodes of {node_size}')


def make_multihost_mesh(num_model_partitions: int = 1,
                        dcn_data_parallelism: Optional[int] = None,
                        device=None) -> partitioning.Mesh:
  """Mesh over all processes; optionally checked as hybrid intra x inter node.

  With dcn_data_parallelism (the number of nodes; torchrun's
  LOCAL_WORLD_SIZE processes to a node, ranks contiguous per node), each
  model group lies inside one node and the data axis crosses nodes, as the
  JAX package keeps model-parallel collectives on ICI and the data axis on
  DCN.  The layout is make_mesh's; a node count or size that does not fit
  raises ValueError.
  """
  if dcn_data_parallelism:
    world = dist.get_world_size() if dist.is_initialized() else 1
    node_size = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    check_hybrid(world, node_size, num_model_partitions,
                 dcn_data_parallelism)
  return partitioning.make_mesh(num_model_partitions, device=device)
