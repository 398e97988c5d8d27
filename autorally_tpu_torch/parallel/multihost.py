"""Multi-host setup: the ``torch.distributed`` bootstrap and host-aware
meshes (port of ``autorally_tpu/parallel/multihost.py``).

Crossing hosts changes nothing in the solvers: the same collectives run
over a process group whose ranks span hosts.  What multi-host does need
is the bootstrap and a mesh whose axis order keeps the heavy axis inside a
host:

- the rollouts axis varies fastest within a host, so that the weighted
  sum's all-reduce rides the host's own links;
- an optional ensemble axis maps across hosts (members exchange nothing
  but the final reductions).

Typical launch (one process a card, ``torchrun`` style: ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE`` and ``GROUP_RANK`` in the environment)::

    from autorally_tpu_torch.parallel.multihost import (
        initialize, multihost_rollout_mesh)
    initialize(coordinator="10.0.0.1:8476", num_processes=8,
               process_id=rank, backend="nccl")
    mesh = multihost_rollout_mesh()
    solver = ShardedMPPISolver(model, cost, cfg, mesh=mesh)

Every process runs the same program; the controller state is replicated
and each rank computes its rollout shard.  State I/O (pose in, control
out) happens on the primary only.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from autorally_tpu_torch.parallel.mesh import ROLLOUT_AXIS, Mesh


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               initialization_timeout: Optional[float] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group (nothing for one process, or when this
    process already joined one).

    ``coordinator``: ``host:port`` of rank 0's store (or an ``init_method``
    URL such as ``file:///path``); ``initialization_timeout``: seconds to
    wait for the other ranks before raising (default: torch's);
    ``backend``: ``"nccl"`` or ``"gloo"``, by default NCCL on a machine
    with a card and gloo on one without.  A bad coordinator or a wrong
    count raises; it never leaves the process single-host."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator is None:
        raise ValueError("initialize needs the coordinator's address for "
                         f"{num_processes} processes")
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id, **kw)


def _local_size() -> int:
    """Ranks a host: ``LOCAL_WORLD_SIZE``, else the host's cards (one
    rank on a host without a card)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return max(torch.cuda.device_count(), 1)


def _host_order() -> list:
    """Every rank, ordered by (host, local rank): ``GROUP_RANK`` and
    ``LOCAL_RANK`` where set, else rank // and % the local size."""
    if not dist.is_initialized():
        return [0]
    rank, per_host = dist.get_rank(), _local_size()
    key = (int(os.environ.get("GROUP_RANK", rank // per_host)),
           int(os.environ.get("LOCAL_RANK", rank % per_host)), rank)
    keys = [None] * dist.get_world_size()
    dist.all_gather_object(keys, key)
    return [k[2] for k in sorted(keys)]


def multihost_rollout_mesh() -> Mesh:
    """1-D rollouts mesh over every rank of every host, the ranks of one
    host adjacent."""
    return Mesh(np.array(_host_order()), (ROLLOUT_AXIS,))


def multihost_ensemble_mesh(ensemble_axis: str = "ensemble",
                            rollout_axis: str = ROLLOUT_AXIS) -> Mesh:
    """2-D (hosts x local ranks) mesh: ensemble members across hosts,
    rollouts across each host's ranks."""
    order = _host_order()
    per_host = min(_local_size(), len(order))
    if len(order) % per_host:
        raise ValueError(f"{len(order)} ranks are not whole hosts of "
                         f"{per_host}")
    grid = np.array(order).reshape(len(order) // per_host, per_host)
    return Mesh(grid, (ensemble_axis, rollout_axis))


def is_primary() -> bool:
    """True on the rank that owns state I/O (pose in / control out)."""
    return not dist.is_initialized() or dist.get_rank() == 0
