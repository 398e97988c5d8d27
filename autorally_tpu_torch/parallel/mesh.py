"""Rank meshes over a ``torch.distributed`` process group (port of
``autorally_tpu/parallel/mesh.py``).

A JAX mesh is named axes over the devices of one program; a torch rank is
a process, so here a mesh is named axes over the ranks of the process
group.  It gives each axis's size (``mesh.shape[axis]``), this rank's
index on each axis, and the process group to reduce over for any set of
its axes.

Every process builds the same meshes in the same order: creating a group
(``dist.new_group``) is a collective of the whole process group, so a
mesh makes all of its groups when it is built, never lazily.  Without an
initialised process group a mesh is one rank, rank 0, with no
collectives: a solver on it runs its body inline.

``torch.distributed.device_mesh.DeviceMesh`` is not used: it needs an
initialised process group even for one rank (the one-rank mesh of a
single-process solver) and binds a device type to the mesh, while these
meshes serve CPU ranks over gloo, ranks that share one card over gloo and
ranks with a card each over NCCL alike.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

ROLLOUT_AXIS = "rollouts"


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if _initialised():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Named axes over process-group ranks (``ranks``: an integer array of
    the mesh's shape).  ``shape`` maps each axis name to its size, as the
    JAX ``Mesh.shape`` does."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim}-D ranks for axes {axis_names}")
        self.ranks = ranks
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, ranks.shape))
        self.size = int(ranks.size)
        rank, _ = _world()
        if not _initialised():
            self._groups = None
        else:
            # every subset of axes, each a group per coordinate of the
            # others; new_group is called by every rank in the same order
            self._groups = {}
            for n in range(1, len(axis_names) + 1):
                for axes in itertools.combinations(range(ranks.ndim), n):
                    self._groups[axes] = self._axis_groups(axes, rank)
        here = np.argwhere(ranks == rank)
        self.coords = tuple(int(c) for c in here[0]) if len(here) else None

    def _axis_groups(self, axes, rank):
        """The group of ``rank`` along ``axes`` (None when it is not in the
        mesh), creating every group along those axes."""
        rest = [d for d in range(self.ranks.ndim) if d not in axes]
        moved = np.moveaxis(self.ranks, rest + list(axes),
                            range(self.ranks.ndim))
        flat = moved.reshape(-1, int(np.prod([self.ranks.shape[d]
                                              for d in axes])))
        mine = None
        for members in flat:
            members = [int(r) for r in members]
            group = dist.new_group(members)
            if rank in members:
                mine = group
        return mine

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.tolist()})"

    @property
    def has_collectives(self) -> bool:
        """Whether the mesh's reductions run over a process group."""
        return self._groups is not None

    def index(self, axis: str) -> int:
        """This rank's index on ``axis`` (``lax.axis_index``)."""
        if self.coords is None:
            raise ValueError(f"rank {_world()[0]} is not in {self}")
        return self.coords[self.axis_names.index(axis)]

    def group(self, axes: Optional[Sequence[str]] = None):
        """The process group of this rank along ``axes`` (all axes when
        None)."""
        axes = self.axis_names if axes is None else tuple(axes)
        if self._groups is None:
            raise RuntimeError("a mesh without a process group has no "
                               "collectives")
        key = tuple(sorted(self.axis_names.index(a) for a in axes))
        return self._groups[key]

    def all_reduce(self, x: torch.Tensor, op: str,
                   axes: Optional[Sequence[str]] = None) -> torch.Tensor:
        """``x`` reduced (``"min"`` or ``"sum"``) over ``axes`` (all axes
        when None), a new tensor equal on every rank of the group."""
        out = x.clone()
        dist.all_reduce(out, op={"min": dist.ReduceOp.MIN,
                                 "sum": dist.ReduceOp.SUM}[op],
                        group=self.group(axes))
        return out


def _ranks(ranks: Optional[Sequence[int]]) -> list:
    return list(range(_world()[1])) if ranks is None else list(ranks)


def rollout_mesh(ranks: Optional[Sequence[int]] = None) -> Mesh:
    """1-D mesh over all (or the given) ranks along the rollouts axis; one
    rank without an initialised process group."""
    return Mesh(np.array(_ranks(ranks)), (ROLLOUT_AXIS,))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """N-D mesh, e.g. ``make_mesh((hosts, cards), ('ensemble',
    'rollouts'))``."""
    ranks = _ranks(ranks)
    n = int(np.prod(shape))
    if n != len(ranks):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                         f"have {len(ranks)}")
    return Mesh(np.array(ranks).reshape(tuple(shape)), tuple(axis_names))
