"""Real-time gate: prove that the deployed control stack holds its budget
(port of ``autorally_tpu/runtime/realtime_gate.py``).

The reference's real-time claim lives in ``runControlLoop``'s paced sleep
(``run_control_loop.cuh:304-318``) but is never asserted: a slow tick
silently eats into the next period.  This harness runs the deployment
stack (a simulator node in a second OS process, the native UDP pose and
command transport, ring buffers, the tube's two controllers and their
arbitration, DDP feedback gains, the absolute-deadline pacer) for N
seconds and reports tick-latency percentiles and missed deadlines, so that
a caller can gate on ``p99 < budget`` and ``missed == 0``.

Both gates run on the card unless given ``device="cpu"`` (raising without a
GPU).  The simulator is ``python -m autorally_tpu_torch.tools.sim_node
--cpu`` on the same model: the reference ``.npz`` weights are not in the
repository, so both processes use seeded weights (``init_params(0)``,
written with ``save_params`` to a temporary ``.npz``), which the result's
``weights`` says.  A warm-up pass (its own loop invocation) takes the
captures and the first ticks before the measured passes; the reference has
the same warm-up implicitly (its first GPU launches amortize before the
vehicle is armed).  The result also says how many captures
(``runtime/profiling.count_solve_traces``) and full collections of
Python's cyclic collector (``gc.callbacks``) fell into the measured
passes, and the warm-up's first tick.
"""

from __future__ import annotations

import gc
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

_ROOT = Path(__file__).resolve().parent.parent.parent
SEEDED = "seeded init_params(0) (the reference .npz is not in the repository)"


def free_udp_ports(n: int) -> list:
    """``n`` distinct UDP ports the OS had free (bound together, then
    released: another process may take one in between, as with any such
    pick)."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _measured_passes(run_pass, hz: float, seconds: float, attempts: int
                     ) -> dict:
    """The measurement harness of both gates: up to ``attempts`` passes
    with Python's cyclic collector parked (a collection pause is 10+ ms of
    stop-the-world; reference counting still reclaims) and best-effort
    SCHED_FIFO, pooling per-tick samples that the validity test keeps until
    ``seconds * hz * 1.5`` valid ticks accumulate.

    ``run_pass(hook)`` runs one pass of ``seconds * hz`` loop ticks,
    calling ``hook()`` once a tick AFTER the tick's work (so consecutive
    (monotonic, process_time) marks bracket the previous pace-sleep and
    this tick), and returns the pass's ``TimingStats``.

    The CPU-backing test: a tick's work is CPU-bound and does not block,
    except for the time blocked on a device harvest, which the loop records
    in ``harvest_samples_ms`` (0 for the sequential loop) and which is taken
    off the wall side first.  A tick whose remaining wall latency exceeds
    the CPU the whole process burned in the bracketing window by more than
    half the budget was stalled by the host (steal, run-queue wait, page
    faults, a paused VM: a preempted or blocked thread accrues no CPU
    time), and is *void*.  The port's other waits for the card (the
    sequential loop's solves read back their costs, the chosen gains are
    copied to the host; the async loop's dispatch) go through CUDA's
    default synchronization, which spins while the process has fewer
    active contexts than cores, so those waits burn the CPU time they take
    and do not void a tick.  A loop that overruns systematically burns
    real CPU in its slow ticks, so those stay valid.  Paced misses count
    only when the tick's own work overran the period (a late wake from the
    absolute-deadline sleep is not the sleeping thread's fault).

    Returns {valid: [(tick_ms, missed)], all_ticks, harvests, net_ticks,
    ages, tainted, used, timing, attempts, missed_raw,
    full_collections}: ``net_ticks`` are tick latencies less the harvest
    wait; ``attempts`` per-pass summaries; ``missed_raw`` the UNCENSORED
    count of wall-clock deadline misses over every tick (tainted ticks and
    paced late wakes included), where each tick's ``missed`` is censored to
    the misses the stack caused; ``full_collections`` the generation-2
    collections that started inside a measured tick's work.
    """
    gc.collect()
    gc.disable()
    starts = []                     # monotonic starts of full collections

    def on_gc(phase, info):
        if phase == "start" and info.get("generation") == 2:
            starts.append(time.monotonic())

    gc.callbacks.append(on_gc)
    fifo = _try_sched_fifo()
    budget_ms = 1000.0 / hz
    target_valid = int(seconds * hz * 1.5)
    valid, all_ticks, harvests, net_ticks, ages, per_attempt = \
        [], [], [], [], [], []
    tainted = used = missed_raw = full_collections = 0
    timing = None
    try:
        for _ in range(max(1, attempts)):
            used += 1
            marks = []

            def hook(*_args):
                marks.append((time.monotonic(), time.process_time()))

            starts.clear()
            windows = []            # each tick's work on the monotonic clock
            t_pre = (time.monotonic(), time.process_time())
            timing = run_pass(hook)
            prev = t_pre
            a_valid = []
            a_missed_raw = 0
            for i, mark in enumerate(marks):
                tick_ms = timing.tick_samples_ms[i]
                harvest_ms = (timing.harvest_samples_ms[i]
                              if i < len(timing.harvest_samples_ms) else 0.0)
                all_ticks.append(tick_ms)
                harvests.append(harvest_ms)
                net_ticks.append(max(0.0, tick_ms - harvest_ms))
                a_missed_raw += int(timing.missed_samples[i])
                windows.append((mark[0] - tick_ms / 1000.0, mark[0]))
                cpu_ms = (mark[1] - prev[1]) * 1000.0
                prev = mark
                if tick_ms - harvest_ms - cpu_ms > budget_ms / 2.0:
                    tainted += 1
                    continue
                missed = timing.missed_samples[i]
                if missed and tick_ms <= budget_ms:
                    missed = 0
                valid.append((tick_ms, missed))
                a_valid.append((tick_ms, missed))
            missed_raw += a_missed_raw
            full_collections += sum(
                1 for t in starts if any(a <= t <= b for a, b in windows))
            ages.extend(getattr(timing, "age_samples_s", []) or [])
            per_attempt.append({
                "p99_ms": _pct([v[0] for v in a_valid], 99.0),
                "missed": sum(v[1] for v in a_valid),
                "missed_raw": a_missed_raw,
                "valid_ticks": len(a_valid),
            })
            if len(valid) >= target_valid:
                break
    finally:
        gc.callbacks.remove(on_gc)
        gc.enable()
        if fifo:
            _drop_sched_fifo()
    return {"valid": valid, "all_ticks": all_ticks, "harvests": harvests,
            "net_ticks": net_ticks, "ages": ages, "tainted": tainted,
            "used": used, "timing": timing, "attempts": per_attempt,
            "missed_raw": missed_raw, "full_collections": full_collections}


def _pct(samples, p: float):
    from autorally_tpu_torch.runtime.telemetry import _nearest_rank

    if not samples:
        return None
    return round(_nearest_rank(sorted(samples), p), 3)


def _summary(res: dict, hz: float) -> dict:
    """The keys both gates return from :func:`_measured_passes`' result."""
    vt = [v[0] for v in res["valid"]]
    timing = res["timing"]
    return {
        "p50_ms": _pct(vt, 50.0),
        "p99_ms": _pct(vt, 99.0),
        "missed": sum(v[1] for v in res["valid"]),
        "missed_raw": res["missed_raw"],
        "ticks": len(res["all_ticks"]),
        "valid_ticks": len(res["valid"]),
        "tainted_ticks": res["tainted"],
        "budget_ms": 1000.0 / hz,
        "attempts_used": res["used"],
        "p99_all_ms": _pct(res["all_ticks"], 99.0),
        "full_collections": res["full_collections"],
        "pacer": getattr(timing, "pacer", None),
        "raw": timing.as_dict() if timing is not None else {},
    }


class _Rig:
    """The simulator process on seeded weights and the UDP plant that
    listens to it; closing stops both."""

    def __init__(self, model, params, dt: float, num_timesteps: int,
                 hz: int, duration: float, pose_port: Optional[int],
                 control_port: Optional[int], use_feedback_gains: bool):
        from autorally_tpu_torch.runtime.udp_plant import UdpPlant

        if pose_port is None or control_port is None:
            pose_port, control_port = free_udp_ports(2)
        self._dir = tempfile.TemporaryDirectory()
        self.sim = self.plant = None
        try:
            npz = os.path.join(self._dir.name, "seeded_nnet.npz")
            model.save_params(params, npz)
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [str(_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
            self.sim = subprocess.Popen(
                [sys.executable, "-m", "autorally_tpu_torch.tools.sim_node",
                 "--cpu", "--model", npz, "--hz", str(hz), "--duration",
                 str(duration), "--pose-port", str(pose_port),
                 "--control-port", str(control_port)],
                env=env, cwd=str(_ROOT), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            self.plant = UdpPlant(dt=dt, num_timesteps=num_timesteps,
                                  pose_port=pose_port,
                                  control_port=control_port, fmt="state",
                                  use_feedback_gains=use_feedback_gains)
            self.plant.start()
            deadline = time.time() + 60
            while (self.plant.pose_count == 0 and time.time() < deadline
                   and self.sim.poll() is None):
                time.sleep(0.05)
            if self.plant.pose_count == 0:
                raise RuntimeError("no poses from the simulator process")
        except BaseException:
            self.close()
            raise

    def close(self) -> str:
        """Stop the plant and the simulator; returns the simulator's
        output."""
        out = ""
        if self.plant is not None:
            self.plant.stop()
            self.plant = None
        if self.sim is not None:
            self.sim.terminate()
            try:
                out = self.sim.communicate(timeout=10)[0] or ""
            except subprocess.TimeoutExpired:
                self.sim.kill()
                out = self.sim.communicate()[0] or ""
            self.sim = None
        self._dir.cleanup()
        return out


def _oval_stack(num_rollouts: int, num_timesteps: int, hz: int, dev,
                **cfg_kw):
    """The gates' solver on the oval of ``oval_track(ppm=2.0)``, seeded
    MLP weights: (cfg, model, params, solver, costmap, cost params)."""
    from autorally_tpu_torch.config import CostParams, MPPIConfig
    from autorally_tpu_torch.costs import MPPICost, make_costmap
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.track_generator import oval_track

    cfg = MPPIConfig(num_rollouts=num_rollouts, num_timesteps=num_timesteps,
                     hz=hz, **cfg_kw)
    cm = make_costmap(*oval_track(ppm=2.0), device=dev)
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device=dev)
    params = model.init_params(0)
    solver = MPPISolver(model, MPPICost(), cfg, device=dev)
    return cfg, model, params, solver, cm, CostParams(desired_speed=4.0)


def run_realtime_gate(pose_port: Optional[int] = None,
                      control_port: Optional[int] = None,
                      hz: int = 50, seconds: float = 3.0,
                      num_rollouts: int = 64, num_timesteps: int = 16,
                      use_feedback_gains: bool = True,
                      warmup_iters: int = 8, attempts: int = 6,
                      device=None) -> dict:
    """Run the two-process realtime loop (the sequential
    ``run_control_loop``) and return its timing.

    The two controllers share one DDP solver when ``use_feedback_gains``
    (each runs it on its own CUDA stream), so the ticks compute and publish
    gains.  Percentiles and the missed count are over the valid ticks of
    :func:`_measured_passes`, pooled across up to ``attempts`` passes;
    ``missed`` counts the misses the stack caused, ``missed_raw`` every
    wall-clock overrun.  A caller should require both (``missed == 0``, and
    ``missed_raw == 0`` when no tick was tainted, else at most the tainted
    count plus 2) and gate only on enough valid ticks to carry a p99.
    Also returns ``first_tick_ms`` (the warm-up's first tick), ``captures``
    (the DDP's CUDA-graph captures in the measured passes), ``weights``
    and ``device``.  Raises ``RuntimeError`` without a GPU (unless
    ``device="cpu"``) and when the simulator produces no poses."""
    from autorally_tpu_torch.config import resolve_device
    from autorally_tpu_torch.runtime.control_loop import (ControlLoopConfig,
                                                          run_control_loop)
    from autorally_tpu_torch.runtime.controller import Controller
    from autorally_tpu_torch.runtime.profiling import count_solve_traces
    from autorally_tpu_torch.solver.ddp import DDPSolver

    dev = resolve_device(device)
    cfg, model, params, solver, cm, cp = _oval_stack(
        num_rollouts, num_timesteps, hz, dev)
    ddp = (DDPSolver(model, cfg.dt, cfg.num_timesteps, device=dev)
           if use_feedback_gains else None)
    actual = Controller(solver, params, cp, cm, ddp=ddp)
    predicted = Controller(solver, params, cp, cm, ddp=ddp, seed=9)
    duration = seconds * attempts + warmup_iters / hz + 60.0
    rig = _Rig(model, params, cfg.dt, cfg.num_timesteps, hz, duration,
               pose_port, control_port, use_feedback_gains)
    try:
        lcfg = ControlLoopConfig(hz=cfg.hz, num_timesteps=cfg.num_timesteps,
                                 use_feedback_gains=use_feedback_gains,
                                 realtime=True, max_iter=warmup_iters)
        warm = run_control_loop(predicted, actual, rig.plant, lcfg)
        traces = (count_solve_traces(ddp) if ddp is not None
                  else {"n": 0})
        lcfg.max_iter = int(seconds * hz)
        res = _measured_passes(
            lambda hook: run_control_loop(predicted, actual, rig.plant, lcfg,
                                          on_tick=hook),
            hz, seconds, attempts)
        return {**_summary(res, hz),
                "first_tick_ms": warm.tick_samples_ms[0],
                "captures": traces["n"], "weights": SEEDED,
                "device": str(dev), "num_rollouts": num_rollouts,
                "num_timesteps": num_timesteps}
    finally:
        rig.close()


def run_realtime_gate_async(pose_port: Optional[int] = None,
                            control_port: Optional[int] = None,
                            hz: int = 50, seconds: float = 3.0,
                            num_rollouts: int = 1920,
                            num_timesteps: int = 100,
                            use_feedback_gains: bool = True,
                            depth: int = 2,
                            adaptive_depth: bool = True,
                            max_depth: Optional[int] = None,
                            warmup_iters: int = 12,
                            attempts: int = 6,
                            noise_sampler: str = "gaussian",
                            noise_param: float = 1.0,
                            num_rollouts_predicted: Optional[int] = None,
                            device=None) -> dict:
    """The realtime gate over the ASYNC-dispatch loop at the reference's
    operating point (K=1920, T=100), the tick one CUDA graph on the card.

    The loop keeps ``depth`` tube ticks in flight, so the device's tick
    hides behind ``depth`` periods; a tick's host work is the dispatch
    (the noise draws and the replay's launch), the harvest and the
    publication, and the pacing.  With ``adaptive_depth`` (default) the
    warm-up pass learns the depth (written back into the loop's config)
    and the measured passes go on adapting; ``max_depth`` defaults to
    ``depth + 2``.  The validity test of :func:`run_realtime_gate` applies
    with the harvest's wait, which is blocked on the device, first taken
    off the wall side (it still counts against the budget).
    ``num_rollouts_predicted`` sizes an asymmetric tube.

    Returns :func:`run_realtime_gate`'s keys (``captures`` now the tube's)
    and ``depth``, ``depth_final``, ``depth_max``, ``harvest_p50_ms``,
    ``harvest_p99_ms``, ``age_p50_s``, ``age_p99_s`` (the published
    solution's pose-anchor age, pooled), ``p99_net_ms`` (tick less
    harvest), the per-pass ``attempts`` and ``best_attempt_p99_ms``."""
    from autorally_tpu_torch.config import resolve_device
    from autorally_tpu_torch.runtime.async_loop import (AsyncLoopConfig,
                                                        AsyncTubeController,
                                                        run_control_loop_async)
    from autorally_tpu_torch.runtime.profiling import count_solve_traces

    dev = resolve_device(device)
    # the stack is built before the simulator starts, so that its lifetime
    # budgets for the warm-up, not for construction
    cfg, model, params, solver, cm, cp = _oval_stack(
        num_rollouts, num_timesteps, hz, dev, noise_sampler=noise_sampler,
        noise_param=noise_param)
    solver_pred = (solver.with_rollouts(num_rollouts_predicted)
                   if num_rollouts_predicted is not None else None)
    tube = AsyncTubeController(solver, params, cp, cm,
                               use_feedback_gains=use_feedback_gains,
                               solver_predicted=solver_pred)
    duration = seconds * attempts + (warmup_iters + 20) / hz + 120.0
    rig = _Rig(model, params, cfg.dt, cfg.num_timesteps, hz, duration,
               pose_port, control_port, use_feedback_gains)
    try:
        if max_depth is None:
            max_depth = depth + 2 if adaptive_depth else depth
        lcfg = AsyncLoopConfig(hz=cfg.hz, num_timesteps=cfg.num_timesteps,
                               depth=depth, realtime=True,
                               adaptive_depth=adaptive_depth,
                               max_depth=max_depth, carry_learned=True,
                               max_iter=warmup_iters)
        warm = run_control_loop_async(tube, rig.plant, lcfg)
        traces = count_solve_traces(tube)
        lcfg.max_iter = int(seconds * hz)
        res = _measured_passes(
            lambda hook: run_control_loop_async(tube, rig.plant, lcfg,
                                                on_loop_tick=hook),
            hz, seconds, attempts)
        timing = res["timing"]
        return {
            **_summary(res, hz),
            "first_tick_ms": warm.tick_samples_ms[0],
            "captures": traces["n"], "weights": SEEDED, "device": str(dev),
            "depth": depth, "adaptive_depth": adaptive_depth,
            "depth_final": getattr(timing, "async_depth_final", depth),
            "depth_max": getattr(timing, "async_depth_max", depth),
            "num_rollouts": num_rollouts,
            "num_rollouts_predicted": (num_rollouts
                                       if num_rollouts_predicted is None
                                       else num_rollouts_predicted),
            "num_timesteps": num_timesteps,
            "harvest_p50_ms": _pct(res["harvests"], 50.0),
            "harvest_p99_ms": _pct(res["harvests"], 99.0),
            "age_p50_s": _pct(res["ages"], 50.0),
            "age_p99_s": _pct(res["ages"], 99.0),
            "p99_net_ms": _pct(res["net_ticks"], 99.0),
            "attempts": res["attempts"],
            "best_attempt_p99_ms": min(
                (a["p99_ms"] for a in res["attempts"]
                 if a["p99_ms"] is not None), default=None),
        }
    finally:
        rig.close()


def _try_sched_fifo(prio: int = 10) -> bool:
    """Best-effort SCHED_FIFO for the control thread (Linux applies
    ``sched_setscheduler(0, ...)`` to the calling thread).  Without the
    capability this is a no-op and the gate rides the normal scheduler."""
    try:
        os.sched_setscheduler(0, os.SCHED_FIFO, os.sched_param(prio))
        return True
    except (AttributeError, PermissionError, OSError):
        return False


def _drop_sched_fifo() -> None:
    try:
        os.sched_setscheduler(0, os.SCHED_OTHER, os.sched_param(0))
    except (AttributeError, PermissionError, OSError):
        pass


def main(argv=None) -> int:
    """CLI: run a gate and print its result as one JSON line."""
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="the controller on the CPU (default: the card)")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--hz", type=int, default=50)
    ap.add_argument("--attempts", type=int, default=6)
    ap.add_argument("--pose-port", type=int, default=None,
                    help="default: a free port from the OS")
    ap.add_argument("--control-port", type=int, default=None)
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="the async-dispatch loop at K=1920/T=100 (the "
                         "50 Hz proof on the card)")
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--fixed-depth", action="store_true",
                    help="disable adaptive pipeline depth")
    ap.add_argument("--rollouts", type=int, default=None,
                    help="K (default 1920 async, 64 sequential)")
    ap.add_argument("--timesteps", type=int, default=None,
                    help="T (default 100 async, 16 sequential)")
    args = ap.parse_args(argv)
    kw = dict(pose_port=args.pose_port, control_port=args.control_port,
              hz=args.hz, seconds=args.seconds, attempts=args.attempts,
              device="cpu" if args.cpu else None)
    if args.rollouts is not None:
        kw["num_rollouts"] = args.rollouts
    if args.timesteps is not None:
        kw["num_timesteps"] = args.timesteps
    if args.use_async:
        res = run_realtime_gate_async(depth=args.depth,
                                      adaptive_depth=not args.fixed_depth,
                                      **kw)
    else:
        res = run_realtime_gate(**kw)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
