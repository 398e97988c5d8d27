"""Run a function on N ranks of a ``torch.distributed`` process group.

A JAX mesh is a set of devices inside one process; a torch rank is a
process.  This module is the port's stand-in for the JAX package's virtual
devices: it starts N ranks with the ``spawn`` method (CUDA forbids
``fork``), which meet at a ``file://`` rendezvous in a temporary directory
(no TCP port, so parallel test workers cannot collide), each with an
explicit device (``cuda:{rank % device_count}`` or ``cpu``), under one
timeout for the whole run.  A rank that fails fails the run: the parent
stops the others and raises with that rank's traceback.  Each rank's
result comes back with its tensors as numpy arrays.

The backend is an explicit argument and never switches on its own:

- ``"nccl"`` where each rank has a card of its own (and for one rank on
  one card); NCCL refuses two ranks on one card, so asking it for ranks
  that share a card raises and names gloo;
- ``"gloo"`` for CPU ranks and for ranks that share a card (gloo reduces
  CUDA tensors through the host).

The rank function is pickled by reference, so it lives in an importable
module (or the ``__main__`` script): :func:`sharded_programs` is the one
the tests and ``chip_smoke.py`` run.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def check_backend(backend: str, device: str, nprocs: int) -> None:
    """Raise unless ``backend`` can run ``nprocs`` ranks on ``device``
    (``"cpu"`` or ``"cuda"``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r} is not 'cpu' or 'cuda'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA ranks requested but no GPU is available")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("NCCL reduces CUDA tensors only: use "
                             "backend='gloo' for CPU ranks")
        cards = torch.cuda.device_count()
        if nprocs > cards:
            raise ValueError(
                f"NCCL refuses two ranks on one GPU: {nprocs} ranks on "
                f"{cards} card(s); use backend='gloo' for ranks that share "
                "a card")


def to_numpy(obj):
    """``obj`` with every tensor a numpy array (dicts, lists and tuples
    recursively; a NamedTuple becomes a dict)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: to_numpy(v) for k, v in zip(obj._fields, obj)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def _rank_main(rank: int, nprocs: int, init: str, backend: str, device: str,
               timeout: float, fn: Callable, args: tuple, out_dir: str
               ) -> None:
    out = Path(out_dir)
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            # one core a CPU rank, as a virtual device has
            dev = torch.device("cpu")
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=init, world_size=nprocs, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(dev, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            dist.destroy_process_group()
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(to_numpy(result), f)
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def run(fn: Callable, nprocs: int, args: Sequence = (), *,
        backend: str = "gloo", device: str = "cpu", timeout: float = 300.0,
        env: Optional[dict] = None) -> list:
    """``fn(device, *args)`` on ``nprocs`` ranks; returns their results in
    rank order.  ``env`` is set in every rank's environment before it
    starts.  Raises with a rank's traceback if one fails, and
    ``TimeoutError`` (after stopping every rank) if the run takes longer
    than ``timeout`` seconds."""
    check_backend(backend, device, nprocs)
    tmp = tempfile.mkdtemp(prefix="artpu_ranks_")
    ctx = mp.get_context("spawn")
    saved = {k: os.environ.get(k) for k in (env or {})}
    procs = []
    try:
        try:
            os.environ.update(env or {})
            for rank in range(nprocs):
                p = ctx.Process(target=_rank_main, args=(
                    rank, nprocs, f"file://{tmp}/store", backend, device,
                    timeout, fn, tuple(args), tmp))
                p.start()
                procs.append(p)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if not p.is_alive() and p.exitcode != 0]
            if failed:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} did "
                                   f"not finish in {timeout} s")
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if not p.is_alive() and p.exitcode != 0:
                err = Path(tmp) / f"rank{r}.err"
                why = (err.read_text() if err.exists()
                       else f"exit code {p.exitcode}")
                raise RuntimeError(f"rank {r} of {nprocs} failed in "
                                   f"{fn.__name__}:\n{why}")
        results = []
        for r in range(nprocs):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------

def _tensors(tree, device):
    """A params tree of numpy leaves as float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v, device) for v in tree)
    return torch.as_tensor(np.asarray(tree), device=device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _drive(solver, params, cost_params, costmap, state, solves: int) -> dict:
    """``solves`` chained solves from the solver's initial state: the last
    controller state and stats, the host ms of each solve (a sync after
    each) and the kernel launches (by name and by (name, K))."""
    from autorally_tpu_torch.ops import rollout_kernel as rk

    cs, stats, ms = solver.init_state(), None, []
    rk.LAUNCHES.clear()
    rk.LAUNCHES_BY_K.clear()
    for _ in range(solves):
        t0 = time.perf_counter()
        cs, stats = solver.solve(params, cost_params, costmap, state, cs)
        _sync(solver.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"U": cs.U, "state_solution": cs.state_solution,
            "control_solution": cs.control_solution, "stats": stats,
            "ms": np.array(ms), "launches": dict(rk.LAUNCHES),
            "launches_by_k": sorted((n, k, v) for (n, k), v
                                    in rk.LAUNCHES_BY_K.items())}


def sharded_program(device: torch.device, spec: dict) -> dict:
    """One rank of a sharded solve described by ``spec``:

    - ``cfg``: ``MPPIConfig`` keywords; ``costmap``: (data, x bounds,
      y bounds); ``cost_params``: ``CostParams`` keywords;
    - ``params``: the MLP's params tree (numpy leaves; stacked for an
      ensemble), or None for ``init_params(seed)``;
    - ``mesh``: None for a 1-D rollouts mesh over every rank
      (``ShardedMPPISolver``, with ``force_collectives``), or (M, R) for an
      (ensemble, rollouts) mesh (``EnsembleShardedMPPISolver``);
    - ``state`` (S,), ``U`` (T, C), ``sub``: the subkey (2,) of one
      iteration;
    - ``solves``: chained solves after the iteration;
    - ``reference`` (one rank only): also the inline solver's iteration
      and solves, and ``MPPISolver``'s iteration on ``fold_in(sub, 0)``'s
      draw.

    Returns the shard's place (``coords``, ``k_offset``, ``K_local``), the
    iteration's U and stats and launches, the shard's own costs, crash
    flags and (T, C) numerator at the global weights (``shard``), the
    solves' results (``solve``), and whether this rank compiled the kernel
    library (``built_here``)."""
    from autorally_tpu_torch.config import (CostParams, MPPIConfig,
                                            effective_gamma)
    from autorally_tpu_torch.costs import MPPICost, make_costmap
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.parallel.ensemble_sharded import \
        EnsembleShardedMPPISolver
    from autorally_tpu_torch.parallel.mesh import make_mesh, rollout_mesh
    from autorally_tpu_torch.parallel.sharded import ShardedMPPISolver
    from autorally_tpu_torch.solver.mppi import MPPISolver

    cfg = MPPIConfig(**spec["cfg"])
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device=device)
    params = (model.init_params(spec.get("seed", 0))
              if spec.get("params") is None
              else _tensors(spec["params"], device))
    costmap = make_costmap(*spec["costmap"], device=device)
    cp = CostParams(**spec.get("cost_params", {}))
    cost = MPPICost(cfg.l1_cost)
    state = torch.as_tensor(spec["state"], dtype=torch.float32,
                            device=device)
    U = torch.as_tensor(spec["U"], dtype=torch.float32, device=device)
    sub = np.asarray(spec["sub"], np.uint32)
    solves = spec.get("solves", 0)

    def sharded(force: bool):
        if spec.get("mesh"):
            mesh = make_mesh(spec["mesh"], ("ensemble", "rollouts"))
            return EnsembleShardedMPPISolver(model, cost, cfg, mesh,
                                             device=device)
        return ShardedMPPISolver(model, cost, cfg, mesh=rollout_mesh(),
                                 force_collectives=force, device=device)

    def iteration(solver) -> dict:
        capacity = solver._use_kernel_rng(costmap)
        rk.LAUNCHES.clear()
        fn = (solver._sharded_rng_iterate if capacity
              else solver._sharded_iterate)
        U_new, stats = fn(params, cp, costmap, state, U, sub)
        _sync(device)
        return {"U": U_new, "stats": stats, "launches": dict(rk.LAUNCHES)}

    solver = sharded(spec.get("force_collectives", False))
    out = {"coords": solver.mesh.coords, "k_offset": solver._k_offset(),
           "K_local": solver._local_rollouts(),
           "inline": solver._inline_body}
    out.update(iteration(solver))
    # the shard's own outputs, at the reduced baseline
    capacity = solver._use_kernel_rng(costmap)
    rollouts = (solver._shard_rng_rollouts if capacity
                else solver._shard_rollouts)
    total, crash, numer = rollouts(params, cp, costmap, state, U,
                                   solver._draw(costmap, sub))
    w = torch.exp(-effective_gamma(cfg, cp)
                  * (total - out["stats"].baseline))
    out["shard"] = {"total": total, "crash": crash, "numer": numer(w)}
    out["solve"] = _drive(solver, params, cp, costmap, state, solves)
    if spec.get("reference"):
        inline = sharded(False)
        if not inline._inline_body:
            raise ValueError("the reference runs on one rank")
        out["reference"] = iteration(inline)
        out["reference"]["solve"] = _drive(inline, params, cp, costmap,
                                           state, solves)
        single = MPPISolver(model, cost, cfg, device=device)
        U_s, st_s = single._iterate_drawn(params, cp, costmap, state, U,
                                          inline._draw(costmap, sub))
        out["single"] = {"U": U_s, "stats": st_s}
    out["built_here"] = (_build._lib is not None
                         and _build._lib.build is not None)
    _sync(device)
    return out


def sharded_programs(device: torch.device, specs) -> list:
    """:func:`sharded_program` of each spec in turn: several sharded runs
    in one launch of the ranks."""
    return [sharded_program(device, spec) for spec in specs]


def multihost_program(device: torch.device, spec: dict) -> dict:
    """One rank of the multi-host launch that ``parallel/multihost.py``
    describes, on ranks that ``LOCAL_WORLD_SIZE`` groups into hosts:
    ``initialize`` (a second call, which does nothing), a sharded solve on
    ``multihost_rollout_mesh()`` from the ``spec`` of
    :func:`sharded_program` (``params`` the MLP's), and a solve of the
    ensemble of ``spec["members"]`` (stacked, one member a host) on
    ``multihost_ensemble_mesh()``.  Only the primary writes
    ``primary_result.npz`` into ``spec["out_dir"]``; rank 1 writes
    ``replica_1.npz``."""
    from autorally_tpu_torch.config import CostParams, MPPIConfig
    from autorally_tpu_torch.costs import MPPICost, make_costmap
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.parallel import multihost
    from autorally_tpu_torch.parallel.ensemble_sharded import \
        EnsembleShardedMPPISolver
    from autorally_tpu_torch.parallel.sharded import ShardedMPPISolver

    multihost.initialize(spec.get("coordinator"), dist.get_world_size(),
                         dist.get_rank())
    cfg = MPPIConfig(**spec["cfg"])
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device=device)
    costmap = make_costmap(*spec["costmap"], device=device)
    cp = CostParams(**spec.get("cost_params", {}))
    state = torch.as_tensor(spec["state"], dtype=torch.float32,
                            device=device)
    mesh = multihost.multihost_rollout_mesh()
    solver = ShardedMPPISolver(model, MPPICost(cfg.l1_cost), cfg, mesh=mesh,
                               device=device)
    cs, stats = solver.solve(_tensors(spec["params"], device), cp, costmap,
                             state, solver.init_state())
    emesh = multihost.multihost_ensemble_mesh()
    ens = EnsembleShardedMPPISolver(model, MPPICost(cfg.l1_cost), cfg, emesh,
                                    device=device)
    ecs, _ = ens.solve(_tensors(spec["members"], device), cp, costmap, state,
                       ens.init_state())
    result = {"U": cs.U, "eU": ecs.U, **to_numpy(stats)}
    out = Path(spec["out_dir"])
    if multihost.is_primary():
        np.savez(out / "primary_result.npz", **to_numpy(result))
    elif dist.get_rank() == 1:
        np.savez(out / "replica_1.npz", **to_numpy(result))
    return {"rollout_ranks": mesh.ranks, "ensemble_shape": emesh.shape,
            "ensemble_ranks": emesh.ranks, "primary": multihost.is_primary(),
            **result}
