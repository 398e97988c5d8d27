"""Async-dispatch control loop: hide the device's latency behind the period
(port of ``autorally_tpu/runtime/async_loop.py``).

The reference's loop is strictly sequential, solve, publish, sleep
(``run_control_loop.cuh:218-312``), which works because its solve returns
in budget.  Here the host *dispatches* tick N and goes on, and *harvests*
tick N - depth, whose outputs have had ``depth`` periods to reach the
host; it publishes that solution to the plant and sleeps to the absolute
deadline.  The published solution is ``depth`` periods older than the
freshest state, as the reference's is during a 20 ms solve: the plant
interpolates the solution at ``t_pose - t_solution``
(``autorally_plant.cpp:215-223``), so an anchor a period or two old costs
interpolation offset, not correctness.  The receding-horizon slide uses the
measured pose stride a dispatch (``run_control_loop.cuh:206-215``).

One tube tick is the slide of both controllers, both solves, the
arbitration with the predicted controller's resync, one DDP run around the
chosen plan and the footprint track cost: ``runtime/episode.py``'s
``tube_solve`` between a device-side slide (``MPPISolver._slide_device``,
which reads the stride from a 0-d buffer) and a write of the outputs into
one flat buffer.  On the card (unless ``eager=True``) the tick is captured
once as one ``torch.cuda.CUDAGraph`` on its own stream and replayed a
dispatch; what it reads from the host goes through pinned slots:

- a dispatch takes a free slot, writes the state, the stride, gamma and the
  capacity mode's keys into its pinned input buffers, and copies them into
  the graph's static buffers without waiting (``non_blocking``); the
  host-noise mode draws each iteration's noise with the solver's own
  generator (``MPPISolver._draw``) into the buffers the graph reads;
- after the replay, on the same stream, the flat outputs are copied into
  the slot's pinned output buffer (``non_blocking``, the port's
  ``copy_to_host_async``) and an event is recorded;
- :meth:`PendingTick.result` waits on that event and copies the outputs
  out of the slot, which then becomes free again.  A slot is reused only
  after its harvest, so neither copy can race the host's next write; the
  slots grow to the number of ticks in flight (``depth + 1``).

Each controller's key is split on the host a dispatch, as the JAX
package's ``init_state(seed)`` and ``_solve`` split it, so the ticks need
not be counted beforehand.  Gamma is a device buffer: a cost-params update
that changes only gamma captures nothing.  Anything else the graph freezes
(the kernels' host scalars: the other cost params, the costmap's transform;
packed weights that are new or changed in place; a costmap of another
shape, or the capacity mode switched) captures again at the next dispatch,
which costs one capture's time (a fraction of a second), and is counted by
``runtime/profiling.count_solve_traces``.  The captured graph's packed
weights are kept alive while it may replay.  On the CPU (``device="cpu"``)
the same tick runs eagerly: no stream, no graph, no pinned memory.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from autorally_tpu_torch.config import CostParams, effective_gamma
from autorally_tpu_torch.costs.mppi_cost import MPPICost
from autorally_tpu_torch.ops import kernel_rng
from autorally_tpu_torch.runtime.controller import stats_degenerate
from autorally_tpu_torch.runtime.episode import (_CARRIED, _signature,
                                                 tube_solve)
from autorally_tpu_torch.runtime.plant import BasePlant
from autorally_tpu_torch.runtime.telemetry import StatusMonitor, TimingStats
from autorally_tpu_torch.solver.ddp import DDPSolver
from autorally_tpu_torch.solver.mppi import (ControllerState, MPPISolver,
                                             validate_tube_pair)


class TubeTickOutput(NamedTuple):
    """Everything the host needs from one tube tick (numpy, harvested)."""

    control_solution: np.ndarray   # (T, C) chosen clamped plan
    state_solution: np.ndarray     # (T, S) chosen nominal trajectory
    feedback_gains: Optional[np.ndarray]  # (T, C, S) or None
    use_actual: np.ndarray         # () bool: the actual-state ctrl won
    trajectory_cost: np.ndarray    # () chosen controller's sum w^2 / eta
    ess: np.ndarray                # ()
    crash_frac: np.ndarray         # ()
    # () max front/back ch-0 track cost at the dispatched state (the
    # degeneracy guard's position gate); None for duck-typed tubes
    position_track_cost: Optional[np.ndarray] = None


class _Slot:
    """The pinned host buffers of one dispatch in flight, and its event."""

    def __init__(self, S: int, n_keys: int, n_out: int, pin: bool):
        host = lambda n, dt: torch.zeros(n, dtype=dt, pin_memory=pin)
        self.state = host(S, torch.float32)
        self.stride = host(1, torch.int64)
        self.gamma = host(1, torch.float32)
        self.keys = [host(n_keys, torch.int64) for _ in range(2)]
        self.out = host(n_out, torch.float32)
        self.event = torch.cuda.Event() if pin else None


class PendingTick:
    """A dispatched tick whose outputs are on their way to the host."""

    def __init__(self, tube: "AsyncTubeController", slot: _Slot):
        self._tube = tube
        self._slot = slot

    def result(self) -> TubeTickOutput:
        """Wait for the tick's outputs (on the card: its event) and return
        them; the slot is free again."""
        slot, tube = self._slot, self._tube
        if slot is None:
            raise RuntimeError("this tick was already harvested")
        if slot.event is not None:
            slot.event.synchronize()
        flat = slot.out.numpy().copy()
        self._slot = None
        tube._free.append(slot)
        return tube._unpack(flat)


class AsyncTubeController:
    """Both tube-MPPI controllers as one dispatchable tick on the solver's
    device (``cuda`` unless the solver was built for the CPU).

    Owns both controllers' carries in device buffers; the host only ever
    reads the small :class:`TubeTickOutput`.  Hot updates (cost params,
    costmap, model weights) take effect at the next dispatch.
    ``solver_predicted``: an asymmetric tube, whose predicted-state half
    runs this solver (it may differ from ``solver`` only in
    ``num_rollouts``)."""

    def __init__(self, solver: MPPISolver, model_params,
                 cost_params: CostParams, costmap,
                 use_feedback_gains: bool = True, seed_actual: int = 0,
                 seed_predicted: int = 1,
                 solver_predicted: Optional[MPPISolver] = None,
                 eager: bool = False):
        validate_tube_pair(solver, solver_predicted)
        self.solver = solver
        self.solver_predicted = solver_predicted or solver
        self.device = solver.device
        self.model_params = model_params
        self.cost_params = cost_params
        self.costmap = costmap
        self.use_feedback_gains = bool(use_feedback_gains)
        self.eager = bool(eager) or self.device.type != "cuda"
        self._seeds = (seed_actual, seed_predicted)
        cfg, model = solver.cfg, solver.model
        self.ddp = (DDPSolver(model, cfg.dt, cfg.num_timesteps,
                              device=self.device)
                    if self.use_feedback_gains else None)
        if self.ddp is not None and not self.eager and (
                self.ddp.cfg.num_iterations != 1 or self.ddp.cfg.use_boxqp):
            raise ValueError(
                "the captured tick runs the DDP's default configuration only "
                f"(one iteration, no box QP), got {self.ddp.cfg}")
        T, S, C = cfg.num_timesteps, model.STATE_DIM, model.CONTROL_DIM
        self._dims = (T, S, C)
        self._n_out = T * C + T * S + (T * C * S if self.ddp else 0) + 5
        f32 = dict(dtype=torch.float32, device=self.device)
        self._carries = [s.init_state(0) for s in self._solvers]
        self._keys = [kernel_rng.prng_key(seed) for seed in self._seeds]
        self._state = torch.zeros(S, **f32)
        self._stride = torch.zeros((), dtype=torch.int64, device=self.device)
        self._gamma = torch.zeros((), **f32)
        self._out = torch.zeros(self._n_out, **f32)
        self._eps: Optional[list] = None      # host-noise draws, by mode
        self._key_bufs: Optional[list] = None  # the capacity mode's keys
        self._free: List[_Slot] = []
        self._stream = None if self.eager else torch.cuda.Stream(self.device)
        self._graph = None
        self._signature = None
        self._keep: list = []

    @property
    def _solvers(self):
        return (self.solver, self.solver_predicted)

    # -- the controllers' states ------------------------------------------------

    def _ordered(self):
        """A context for host reads and writes of the carries outside a
        tick: the current stream waits for the dispatches in flight, and
        the next dispatch waits for what the block enqueued."""
        if self._stream is None:
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def ordered():
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self._stream)
            yield
            self._stream.wait_stream(current)

        return ordered()

    def _get_cs(self, c: int) -> ControllerState:
        with self._ordered():
            carry = self._carries[c]
            fields = [getattr(carry, f).clone() for f in _CARRIED]
        return ControllerState(*fields, key=self._keys[c].copy())

    def _set_cs(self, c: int, cs: ControllerState) -> None:
        with self._ordered():
            for f in _CARRIED:
                getattr(self._carries[c], f).copy_(getattr(cs, f))
        self._keys[c] = np.asarray(cs.key, dtype=np.uint32).copy()

    cs_a = property(lambda self: self._get_cs(0),
                    lambda self, cs: self._set_cs(0, cs),
                    doc="The actual-state controller's state (a copy).")
    cs_p = property(lambda self: self._get_cs(1),
                    lambda self, cs: self._set_cs(1, cs),
                    doc="The predicted-state controller's state (a copy).")

    def reset(self, state: np.ndarray) -> None:
        """Re-seed both controllers at ``state`` (loop init,
        run_control_loop.cuh:146-155)."""
        for c, (s, seed) in enumerate(zip(self._solvers, self._seeds)):
            cs = s.init_state(seed)
            cs.state_solution[0] = torch.as_tensor(
                np.asarray(state, np.float32), device=self.device)
            self._set_cs(c, cs)

    # -- the tick ---------------------------------------------------------------

    def _draws(self, c: int, capacity: bool) -> list:
        """Controller c's draws as ``_solve_drawn`` takes them, from the
        static buffers of the mode."""
        if capacity:
            return list(self._key_bufs[c].view(-1, 2))
        return self._eps[c]

    def _tick(self, capacity: bool) -> None:
        """One tube tick on the static buffers; reads nothing from the
        host, so that it can be captured."""
        cp = self.cost_params.replace(gamma=self._gamma)
        cs_a, cs_p = (s._slide_device(c, self._stride)
                      for s, c in zip(self._solvers, self._carries))
        ts = tube_solve(self._solvers, self.ddp, self.model_params, cp,
                        self.costmap, self._state, cs_a, cs_p,
                        self._draws(0, capacity), self._draws(1, capacity))
        s = self._state
        pos = MPPICost.footprint_track_cost(self.costmap, s[0], s[1], s[2])
        parts = [ts.control.reshape(-1), ts.states.reshape(-1)]
        if ts.gains is not None:
            parts.append(ts.gains.reshape(-1))
        parts += [ts.use_actual.to(torch.float32)[None],
                  ts.stat("trajectory_cost")[None], ts.stat("ess")[None],
                  ts.stat("crash_frac")[None], pos[None]]
        self._out.copy_(torch.cat(parts))
        for carry, new in zip(self._carries, (ts.cs_a, ts.cs_p)):
            for name in _CARRIED:
                getattr(carry, name).copy_(getattr(new, name))

    def _unpack(self, flat: np.ndarray) -> TubeTickOutput:
        T, S, C = self._dims
        i = 0

        def take(n, shape):
            nonlocal i
            i += n
            return flat[i - n:i].reshape(shape)

        control = take(T * C, (T, C))
        states = take(T * S, (T, S))
        gains = take(T * C * S, (T, C, S)) if self.ddp is not None else None
        use_actual, cost, ess, crash, pos = flat[i:i + 5]
        return TubeTickOutput(control, states, gains, np.bool_(use_actual > 0.5),
                              cost, ess, crash, pos)

    def _buffers(self, capacity: bool) -> None:
        """The draw buffers of the mode, made at its first dispatch."""
        if capacity and self._key_bufs is None:
            n = 2 * self.solver.cfg.num_iters
            self._key_bufs = [torch.zeros(n, dtype=torch.int64,
                                          device=self.device)
                              for _ in range(2)]
        if not capacity and self._eps is None:
            C = self.solver.model.CONTROL_DIM
            self._eps = [[torch.zeros((s.cfg.num_timesteps,
                                       s.cfg.num_rollouts, C),
                                      dtype=torch.float32, device=self.device)
                          for _ in range(s.cfg.num_iters)]
                         for s in self._solvers]

    def _capture(self, capacity: bool) -> None:
        """Capture :meth:`_tick` after one eager tick on the tube's stream
        (the kernels' build, the packs, the geometry caches), the carries
        put back as they were, with Python's cyclic collector off."""
        saved = [[getattr(c, f).clone() for f in _CARRIED]
                 for c in self._carries]
        self._tick(capacity)
        for carry, old in zip(self._carries, saved):
            for f, v in zip(_CARRIED, old):
                getattr(carry, f).copy_(v)
        # torch.cuda.graph synchronizes the device before it captures on
        # its own stream
        graph = torch.cuda.CUDAGraph()
        gc.collect()            # an older graph freed mid-capture breaks it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._tick(capacity)
        finally:
            if collecting:
                gc.enable()
        self._graph = graph

    def dispatch(self, state: np.ndarray, stride: int) -> PendingTick:
        """Launch one tube tick from ``state`` after a slide of ``stride``
        (>= 0) steps; returns at once, with the outputs' copy to the host
        enqueued behind the tick."""
        stride = int(stride)
        if stride < 0:
            raise ValueError(f"stride must be >= 0, got {stride}")
        capacity = self.solver._use_kernel_rng(self.costmap)
        self._buffers(capacity)
        slot = (self._free.pop() if self._free else
                _Slot(self._dims[1], 2 * self.solver.cfg.num_iters,
                      self._n_out, pin=not self.eager))
        slot.state.numpy()[:] = np.asarray(state, np.float32)
        slot.stride[0] = stride
        slot.gamma[0] = float(np.float32(effective_gamma(self.solver.cfg,
                                                         self.cost_params)))
        subs = []
        for c in range(2):
            chain = []
            for _ in range(self.solver.cfg.num_iters):
                self._keys[c], sub = kernel_rng.split(self._keys[c])
                chain.append(sub)
            subs.append(chain)
            slot.keys[c].numpy()[:] = np.concatenate(chain).astype(np.int64)
        if self.eager:
            self._stage(slot, subs, capacity)
            self._tick(capacity)
            slot.out.copy_(self._out)
            return PendingTick(self, slot)
        with torch.cuda.stream(self._stream):
            self._stage(slot, subs, capacity)
            keep: list = []
            signature = _signature(
                (self.model_params, self.cost_params.replace(gamma=None),
                 self.costmap, self.solver.cost.__dict__, capacity), keep)
            if self._graph is None or signature != self._signature:
                self._graph = None            # the stale graph goes first
                self._capture(capacity)
                # the kernels read the packed weights by address
                keep += [getattr(o, "_kernel_pack", None)
                         for o in (self.solver.model, self.costmap)]
                self._signature, self._keep = signature, keep
            self._graph.replay()
            slot.out.copy_(self._out, non_blocking=True)
            slot.event.record(self._stream)
        return PendingTick(self, slot)

    def _stage(self, slot: _Slot, subs: list, capacity: bool) -> None:
        """The dispatch's inputs into the static buffers (on the current
        stream): state, stride, gamma, and each controller's draws."""
        nb = not self.eager
        self._state.copy_(slot.state, non_blocking=nb)
        self._stride.copy_(slot.stride[0], non_blocking=nb)
        self._gamma.copy_(slot.gamma[0], non_blocking=nb)
        for c, s in enumerate(self._solvers):
            if capacity:
                self._key_bufs[c].copy_(slot.keys[c], non_blocking=nb)
            else:
                for buf, sub in zip(self._eps[c], subs[c]):
                    buf.copy_(s._draw(self.costmap, sub))

    # -- hot updates (run_control_loop.cuh:182-204) ---------------------------

    def update_cost_params(self, cost_params: CostParams) -> None:
        self.cost_params = cost_params

    def update_costmap(self, costmap) -> None:
        self.costmap = costmap

    def update_model_params(self, model_params) -> None:
        self.model_params = model_params


@dataclasses.dataclass
class AsyncLoopConfig:
    hz: int = 50
    num_timesteps: int = 100
    optimization_stride: int = 1
    depth: int = 1                 # (initial) in-flight solves before harvest
    max_iter: Optional[int] = None
    realtime: bool = True          # False: lockstep against a step_sim plant
    # Adaptive pipeline depth (realtime loops only).  A fixed depth must be
    # sized by hand to the device's dispatch -> ready latency: too shallow
    # and harvest waits leak into the tick's latency when it spikes; too
    # deep and the published solution is needlessly stale.  With
    # adaptive_depth the loop grows ``depth`` (up to ``max_depth``) after
    # ``grow_after`` consecutive ticks whose harvest blocked for more than
    # a quarter period, and shrinks it after ``shrink_after_s`` seconds of
    # back-to-back non-blocking harvests, but never below the highest depth
    # it ever had to grow to (one oscillation a level at most: stability
    # beats freshness for a control loop).  With ``carry_learned`` the
    # learned depth and the pinned floor are written back to ``cfg.depth``
    # / ``cfg.shrink_floor`` at the loop's exit, so a warm-up pass teaches
    # the measured passes.  It is opt-in: a config reused across unrelated
    # tubes or devices must not inherit another loop's depth silently; the
    # learned values are reported in ``timing.async_depth_final`` /
    # ``timing.async_depth_max`` either way.
    adaptive_depth: bool = False
    max_depth: int = 4
    grow_after: int = 3
    shrink_after_s: float = 5.0
    shrink_floor: int = 1
    carry_learned: bool = False
    # Degeneracy guard, as ControlLoopConfig's: a harvested solution whose
    # rollouts nearly all crash-latched with a flat softmax (ESS >>
    # survivors), while the MEASURED car is off the track boundary and
    # faster than the speed gate, publishes with the throttle braked and
    # the gains dropped.  Opt-in (default off): see
    # runtime/controller.py::stats_degenerate.
    degeneracy_guard: bool = False
    degenerate_crash_thresh: float = 0.9
    degenerate_ess_mult: float = 5.0
    degenerate_speed_gate: float = 2.0


def _to_host(out_dev) -> TubeTickOutput:
    """A dispatched tick's outputs on the host: ``PendingTick.result()``,
    or the leaves of a duck-typed tube's output as numpy arrays."""
    result = getattr(out_dev, "result", None)
    if result is not None:
        return result()
    return TubeTickOutput(*[None if leaf is None else np.asarray(leaf)
                            for leaf in out_dev])


def run_control_loop_async(tube: AsyncTubeController, plant: BasePlant,
                           cfg: AsyncLoopConfig,
                           is_alive: Optional[Callable[[], bool]] = None,
                           monitor: Optional[StatusMonitor] = None,
                           on_tick: Optional[Callable] = None,
                           on_loop_tick: Optional[Callable[[int], None]]
                           = None,
                           timing: Optional[TimingStats] = None
                           ) -> TimingStats:
    """Pipelined tube-MPPI loop: dispatch tick N, harvest and publish tick
    N - depth, pace to the deadline (realtime: the native absolute-deadline
    pacer, which must load; lockstep: one ``step_sim`` a tick).

    ``on_tick(num_iter, used, state, out, harvest_ms, age_s)`` fires once
    per *harvested* solution (``used`` is "actual"/"predicted", ``out`` the
    host-side :class:`TubeTickOutput`, ``age_s`` the solution's pose-anchor
    age at publication).  ``on_loop_tick(num_iter)`` fires once per loop
    iteration at the end of the tick's work, before pacing (the realtime
    gate's CPU-bracketing hook).  Returns timing stats whose
    ``tick_samples_ms`` cover dispatch + harvest + publish (sleep excluded)
    and whose ``harvest_samples_ms`` isolate the wait for the device;
    ``timing.pacer`` says which pacer ran, as in ``run_control_loop``:
    "native" (realtime), "lockstep" or "sleep"."""
    alive = is_alive or (lambda: True)
    timing = TimingStats() if timing is None else timing
    stride_default = cfg.optimization_stride
    period = stride_default / cfg.hz
    depth = max(1, int(cfg.depth))
    # adaptive depth (see AsyncLoopConfig): realtime loops only, since
    # lockstep harvests never wait for a clock
    adapt = bool(cfg.adaptive_depth) and cfg.realtime
    max_depth = max(depth, int(cfg.max_depth))
    blocked_thresh_ms = period * 1000.0 / 4.0
    shrink_after = max(1, int(round(cfg.shrink_after_s * cfg.hz)))
    blocked_run = 0
    early_run = 0
    # the highest depth a grow was ever forced to, carried across
    # invocations sharing this cfg (warm-up pass -> measured passes)
    shrink_floor = max(1, int(cfg.shrink_floor))
    depth_max_seen = depth
    depth_changes: list = []

    state = plant.get_state().to_vector()
    tube.reset(state)

    last_pose_time = plant.get_last_pose_time()
    loop_time = period
    status = 1
    num_iter = 0
    degenerate_ticks = 0
    max_iter = cfg.max_iter if cfg.max_iter is not None else 2 ** 31

    lockstep = not cfg.realtime and hasattr(plant, "step_sim")
    pacer = None
    if cfg.realtime:
        from autorally_tpu_torch.runtime.native import Pacer

        pacer = Pacer(period)          # raises if the library cannot load
    timing.pacer = ("native" if pacer is not None
                    else "lockstep" if lockstep else "sleep")

    inflight: collections.deque = collections.deque()

    def harvest() -> float:
        """Publish the oldest in-flight solution; returns the blocked
        device wait in ms."""
        nonlocal degenerate_ticks
        t_disp, state_disp, out_dev = inflight.popleft()
        t0 = time.perf_counter()
        out = _to_host(out_dev)
        wait_ms = (time.perf_counter() - t0) * 1000.0
        used = "actual" if bool(out.use_actual) else "predicted"
        gains = out.feedback_gains if tube.use_feedback_gains else None
        ctrl_seq = out.control_solution
        crash = float(out.crash_frac)
        # crash short-circuits first, and a duck-typed tube without a
        # .solver skips the guard (the ESS-vs-survivors bound needs the
        # winning controller's K); an asymmetric tube tests against the
        # winning controller's own K
        solver_a = getattr(tube, "solver", None)
        solver_w = (solver_a if bool(out.use_actual)
                    else getattr(tube, "solver_predicted", None) or solver_a)
        if (cfg.degeneracy_guard and crash > cfg.degenerate_crash_thresh
                and solver_w is not None
                and stats_degenerate(
                    float(out.ess), crash, solver_w.cfg.num_rollouts,
                    cfg.degenerate_crash_thresh, cfg.degenerate_ess_mult,
                    position_track_cost=(
                        None if out.position_track_cost is None
                        else float(out.position_track_cost)),
                    # duck-typed tubes without cost params fall back to
                    # the stats-only rule
                    boundary_threshold=(
                        None if getattr(tube, "cost_params", None) is None
                        else float(tube.cost_params.boundary_threshold)),
                    # the MEASURED vx at this tick's dispatch
                    speed=float(state_disp[4]),
                    speed_gate=cfg.degenerate_speed_gate)):
            # no-preference plan: brake, drop the gains
            ctrl_seq = ctrl_seq.copy()
            ctrl_seq[:, 1] = min(0.0, float(ctrl_seq[:, 1].min()))
            gains = None
            degenerate_ticks += 1
        plant.set_solution(out.state_solution, ctrl_seq, gains, t_disp, used)
        age = plant.get_last_pose_time() - t_disp
        timing.age_samples_s.append(age)
        if on_tick is not None:
            on_tick(num_iter, used, state, out, wait_ms, age)
        return wait_ms

    try:
        while alive() and num_iter < max_iter and not plant.shutdown:
            tick_start = time.perf_counter()
            num_iter += 1

            # state update (run_control_loop.cuh:176-181)
            t_pose = plant.get_last_pose_time()
            if t_pose != last_pose_time:
                loop_time = t_pose - last_pose_time
                last_pose_time = t_pose
                state = plant.get_state().to_vector()

            # hot updates ride the next dispatch (run_control_loop.cuh:
            # 182-204)
            new_cost, new_map, new_model = plant.take_updates()
            if new_cost is not None:
                tube.update_cost_params(new_cost)
            if new_map is not None:
                tube.update_costmap(new_map)
            if new_model is not None:
                tube.update_model_params(new_model)

            stride = int(round(loop_time * cfg.hz))
            if status != 0:
                stride = stride_default
            if not (0 <= stride < cfg.num_timesteps):
                # an out-of-range pose jump skips the slide, as the
                # sequential loop's stride guard does; a slide of 0 is the
                # identity
                stride = 0

            out_dev = tube.dispatch(state, stride)
            inflight.append((t_pose, state, out_dev))

            harvest_ms = 0.0
            harvested = len(inflight) > depth
            while len(inflight) > depth:
                harvest_ms += harvest()

            if adapt and harvested:
                if harvest_ms > blocked_thresh_ms:
                    blocked_run += 1
                    early_run = 0
                else:
                    early_run += 1
                    blocked_run = 0
                if blocked_run >= cfg.grow_after and depth < max_depth:
                    # the device is consistently slower than the pipeline
                    # covers: deepen it (the next tick skips its harvest)
                    depth += 1
                    shrink_floor = max(shrink_floor, depth)
                    depth_max_seen = max(depth_max_seen, depth)
                    depth_changes.append((num_iter, depth))
                    blocked_run = 0
                elif early_run >= shrink_after and depth > shrink_floor:
                    # sustained non-blocking harvests: trade slack for a
                    # fresher solution (the next tick harvests twice; if
                    # that was premature the grow path recovers and
                    # shrink_floor pins this level)
                    depth -= 1
                    depth_changes.append((num_iter, depth))
                    early_run = 0

            status = (plant.check_status_wall() if cfg.realtime
                      else plant.check_status(plant.get_last_pose_time()))
            if monitor is not None:
                monitor.heartbeat(plant.get_last_pose_time(), status,
                                  f"inflight={len(inflight)}")
            if on_loop_tick is not None:
                on_loop_tick(num_iter)

            tick_s = time.perf_counter() - tick_start

            missed = 0
            if lockstep:
                plant.step_sim(stride_default)    # lockstep sim advance
                last_sleep = 0.0
            elif pacer is not None:
                t_sleep = time.perf_counter()
                missed = pacer.wait()
                last_sleep = time.perf_counter() - t_sleep
            else:
                remaining = period - tick_s
                last_sleep = max(0.0, remaining)
                if remaining > 0:
                    time.sleep(remaining)
                else:
                    missed = int(tick_s / period)

            timing.update(loop_time * 1000.0, tick_s * 1000.0,
                          last_sleep * 1000.0, missed=missed,
                          harvest_ms=harvest_ms)
            plant.set_timing_info(timing.avg_loop_ms, timing.avg_tick_ms,
                                  timing.avg_sleep_ms)

        while inflight:              # drain: leave the freshest solution
            harvest()
    finally:
        if pacer is not None:
            pacer.close()
    # depth telemetry (attributes only the async loop sets)
    timing.degenerate_ticks = degenerate_ticks
    timing.async_depth_initial = max(1, int(cfg.depth))
    timing.async_depth_final = depth
    timing.async_depth_max = depth_max_seen
    timing.async_depth_changes = depth_changes
    if adapt and cfg.carry_learned:
        # teach the next pass (see the config's comment): depth and floor
        cfg.depth = depth
        cfg.shrink_floor = shrink_floor
    return timing
