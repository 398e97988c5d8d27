"""Full-stack tube-MPPI run on the port: the ``path_integral_nn`` process
(the port's ``examples/run_tube_mppi.py``).

Brings up the runtime: dual MPPI controllers (actual-state and
predicted-state) with DDP feedback gains, the plant pipeline with solution
interpolation and feedback application, the tube-MPPI arbitration loop,
the status-monitor watchdog and lap statistics, driving a synthetic plant
around the oval of ``drive_oval`` in lockstep at 50 Hz.  The model, map and
solver come from ``drive_oval.build``: the ``--model`` weights when that
file exists, else seeded ones (Glorot seed 0, or theta ~ N(0, 0.01^2) with
``--bf``).  ``--launch`` loads the configuration from a reference roslaunch
XML file (``param_getter.cpp:75-151``).

Usage::

    python -m autorally_tpu_torch.run_tube_mppi [--ticks 400] [--cpu]
        [--launch XML] [--rollouts K] [--timesteps T] [--bf] [--model PATH]
        [--desired-speed V] [--pred-rollouts K] [--degeneracy-guard]
        [--ess-target FRAC] [--async-loop [--depth N]]

``--ess-target`` adapts the softmax temperature every tick toward an ESS of
FRAC*K (``runtime/ess_tuner.py``: ``EssTuner.attach``, or ``attach_async``
with ``--async-loop``).  ``--async-loop`` runs the async-dispatch loop
(``runtime/async_loop.py``: both controllers one dispatched tick, captured
as one CUDA graph on the card, published ``--depth`` ticks later) in
lockstep against the plant.  The JAX example's telemetry, runstop, log and
camera options are not ported yet; each exits with an error naming its
ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, NamedTuple, Optional

import numpy as np

from autorally_tpu_torch import drive_oval
from autorally_tpu_torch.config import (CostParams, MPPIConfig,
                                        config_from_params,
                                        load_launch_params, resolve_device)
from autorally_tpu_torch.runtime import (ControlLoopConfig, Controller,
                                         LapStats, StatusMonitor,
                                         SyntheticPlant, TimingStats,
                                         run_control_loop)
from autorally_tpu_torch.runtime.async_loop import (AsyncLoopConfig,
                                                    AsyncTubeController,
                                                    run_control_loop_async)
from autorally_tpu_torch.runtime.ess_tuner import EssTuner
from autorally_tpu_torch.solver.ddp import DDPSolver
from autorally_tpu_torch.solver.mppi import validate_tube_pair

# option -> the ROADMAP.md item that ports what it needs
UNPORTED = {
    "--telemetry-port": "Queue 1 item 11 (runtime/telemetry_bus.py)",
    "--runstop-port": "Queue 1 item 11 (runtime/telemetry_bus.py)",
    "--log": "Queue 1 item 11 (runtime/telemetry_bus.py)",
    "--camera": "Queue 1 item 11 (vision/)",
}
# the start line: the segment x in [25, 35] on the +x side (y sign flip)
LAP_LINE = (0.0, 0.0, 25.0, 35.0)


class Tube(NamedTuple):
    """Everything one run drives: the two controllers, the plant, the loop
    and MPPI configurations, and a note on the weights and config used."""

    actual: Controller
    predicted: Controller
    plant: SyntheticPlant
    loop_cfg: ControlLoopConfig
    cfg: MPPIConfig
    note: str


def build(ticks: int = 400, rollouts: Optional[int] = None,
          timesteps: int = 100, model: str = "nn",
          model_path: Optional[str] = None, desired_speed: float = 6.0,
          launch: Optional[str] = None, pred_rollouts: Optional[int] = None,
          degeneracy_guard: bool = False, device=None) -> Tube:
    """The tube of ``examples/run_tube_mppi.py``: one DDP solver shared by
    both controllers (the predicted one seeded 77, with ``pred_rollouts``
    rollouts when given), a lockstep ``SyntheticPlant`` on the same model
    from the oval's start, and a loop of ``ticks`` ticks.  K defaults to
    the model's reference K (1920, or 2560 for ``model="bf"``)."""
    dev = resolve_device(device)
    rollouts = drive_oval.MODELS[model][1] if rollouts is None else rollouts
    note = ""
    if launch:
        params = load_launch_params(launch, env={"AR_MPPI_PARAMS_PATH": ""})
        cfg, cost_params = config_from_params(params)
        cfg = cfg.replace(num_rollouts=rollouts)
        note = (f"config from {launch}: hz={cfg.hz} T={cfg.num_timesteps} "
                f"gamma={cfg.gamma} desired_speed="
                f"{float(cost_params.desired_speed)}\n")
    else:
        cfg = MPPIConfig(num_rollouts=rollouts, num_timesteps=timesteps)
        cost_params = CostParams(desired_speed=desired_speed)
    solver, params_m, cost_params, costmap, weights = drive_oval.build(
        model_path=model_path, device=dev, model=model, cfg=cfg,
        cost_params=cost_params)
    solver_pred = (solver.with_rollouts(pred_rollouts)
                   if pred_rollouts is not None else solver)
    validate_tube_pair(solver, solver_pred)
    ddp = DDPSolver(solver.model, cfg.dt, cfg.num_timesteps, device=dev)
    actual = Controller(solver, params_m, cost_params, costmap, ddp=ddp)
    predicted = Controller(solver_pred, params_m, cost_params, costmap,
                           ddp=ddp, seed=77)

    start = np.array(drive_oval.START, dtype=np.float32)
    plant = SyntheticPlant(solver.model, params_m, start, cfg.dt,
                           cfg.num_timesteps,
                           use_feedback_gains=cfg.use_feedback_gains,
                           throttle_max=cfg.max_throttle)
    plant.receive_state_vector(0.0, start)
    loop_cfg = ControlLoopConfig(hz=cfg.hz, num_timesteps=cfg.num_timesteps,
                                 optimization_stride=cfg.optimization_stride,
                                 use_feedback_gains=cfg.use_feedback_gains,
                                 max_iter=ticks,
                                 degeneracy_guard=degeneracy_guard)
    return Tube(actual, predicted, plant, loop_cfg, cfg, note + weights)


class _Shim:
    """The async loop's harvested ``TubeTickOutput`` where ``drive``'s
    ``on_tick`` consumers take a controller (its ``stats`` and computed
    trajectory cost)."""

    def __init__(self, out):
        self.stats = out

    def get_computed_trajectory_cost(self) -> float:
        return float(self.stats.trajectory_cost)


def async_tube(tube: Tube) -> AsyncTubeController:
    """The tube's two controllers as one ``AsyncTubeController`` (seeds 0
    and 1, as ``examples/run_tube_mppi.py --async-loop`` makes it)."""
    a, p = tube.actual, tube.predicted
    return AsyncTubeController(
        a.solver, a.model_params, a.cost_params, a.costmap,
        use_feedback_gains=tube.cfg.use_feedback_gains,
        solver_predicted=None if p.solver is a.solver else p.solver)


def drive(tube: Tube, log=print, on_tick: Optional[Callable] = None,
          atube: Optional[AsyncTubeController] = None, depth: int = 1,
          on_tick_async: Optional[Callable] = None) -> dict:
    """Run the loop to its ``max_iter`` ticks with the watchdog and lap
    statistics; ``on_tick(i, chosen, used, state)`` also runs every tick.
    With ``atube`` the async loop drives it instead, publishing ``depth``
    ticks late (``chosen`` is then a shim over the harvested output), and
    ``on_tick_async`` takes each harvest first.  Returns the run's timing
    stats, controller usage, laps, monitor and wall seconds."""
    plant = tube.plant
    monitor = StatusMonitor()
    laps = LapStats(line=LAP_LINE)
    used_counts = {"actual": 0, "predicted": 0}

    def tick(i, chosen, used, state):
        used_counts[used] += 1
        rec = laps.process_pose(plant.sim_time, state[0], state[1],
                                state[4], state[5])
        if rec:
            log(f"  LAP {rec.lap_number}: {rec.lap_time:.2f}s "
                f"max_speed={rec.max_speed:.2f} "
                f"max_slip={rec.max_slip:.3f}")
        if i % 100 == 0:
            diag = monitor.diagnostic(plant.get_last_pose_time())
            log(f"tick {i:4d} pos=({state[0]:+7.2f},{state[1]:+7.2f}) "
                f"speed={state[4]:5.2f} using={used:9s} "
                f"monitor={diag['level']}")
        if on_tick is not None:
            on_tick(i, chosen, used, state)

    t_wall = time.time()
    if atube is None:
        timing = run_control_loop(tube.predicted, tube.actual, plant,
                                  tube.loop_cfg, monitor=monitor,
                                  on_tick=tick, timing=TimingStats())
    else:
        lc = tube.loop_cfg

        def harvested(num_iter, used, state, out, harvest_ms, age_s):
            if on_tick_async is not None:
                on_tick_async(num_iter, used, state, out, harvest_ms, age_s)
            tick(num_iter, _Shim(out), used, state)

        acfg = AsyncLoopConfig(hz=lc.hz, num_timesteps=lc.num_timesteps,
                               optimization_stride=lc.optimization_stride,
                               depth=depth, realtime=False,
                               max_iter=lc.max_iter,
                               degeneracy_guard=lc.degeneracy_guard)
        timing = run_control_loop_async(atube, plant, acfg, monitor=monitor,
                                        on_tick=harvested,
                                        timing=TimingStats())
    return {"timing": timing, "used": used_counts, "laps": laps,
            "monitor": monitor, "wall_s": time.time() - t_wall}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=400)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--launch", default=None,
                    help="roslaunch XML to load the config from")
    ap.add_argument("--rollouts", type=int, default=None,
                    help="K (default 1920, or 2560 with --bf)")
    ap.add_argument("--timesteps", type=int, default=100)
    ap.add_argument("--bf", action="store_true",
                    help="basis-function dynamics (path_integral_bf)")
    ap.add_argument("--model", default=None,
                    help="reference .npz weights (default: the model's "
                         "reference file; seeded weights when missing)")
    ap.add_argument("--desired-speed", type=float, default=6.0)
    ap.add_argument("--pred-rollouts", type=int, default=None,
                    help="asymmetric tube: rollout count of the "
                         "predicted-state controller (default: --rollouts)")
    ap.add_argument("--degeneracy-guard", action="store_true",
                    dest="degeneracy_guard",
                    help="brake flat-softmax plans when the measured car "
                         "is off the track boundary at speed")
    ap.add_argument("--ess-target", type=float, default=None,
                    metavar="FRAC",
                    help="adapt the softmax temperature every tick toward "
                         "an ESS of FRAC*K (EssTuner)")
    ap.add_argument("--async-loop", action="store_true",
                    help="async-dispatch loop: both controllers one "
                         "dispatched tick, published --depth ticks later")
    ap.add_argument("--depth", type=int, default=1,
                    help="async-loop ticks in flight before a harvest")
    for opt in UNPORTED:
        ap.add_argument(opt, nargs="?", const=True, default=None,
                        help=f"not ported: {UNPORTED[opt]}")
    args = ap.parse_args(argv)
    for opt, item in UNPORTED.items():
        if getattr(args, opt[2:].replace("-", "_")) is not None:
            ap.error(f"{opt} is not ported yet (ROADMAP.md, {item})")

    tube = build(ticks=args.ticks, rollouts=args.rollouts,
                 timesteps=args.timesteps, model="bf" if args.bf else "nn",
                 model_path=args.model, desired_speed=args.desired_speed,
                 launch=args.launch, pred_rollouts=args.pred_rollouts,
                 degeneracy_guard=args.degeneracy_guard,
                 device="cpu" if args.cpu else None)
    print(tube.note)
    tuner = (None if args.ess_target is None
             else EssTuner(tube.cfg, target_frac=args.ess_target))
    if args.async_loop:
        atube = async_tube(tube)
        out = drive(tube, atube=atube, depth=args.depth,
                    on_tick_async=None if tuner is None
                    else tuner.attach_async(atube))
    else:
        out = drive(tube, on_tick=None if tuner is None
                    else tuner.attach(tube.actual, tube.predicted))
    timing, plant, cfg = out["timing"], tube.plant, tube.cfg
    loop = f"async loop, depth {args.depth}" if args.async_loop else "loop"
    print(f"\n{args.ticks} ticks in {out['wall_s']:.1f}s wall ({loop})")
    print(f"controller usage: {out['used']}")
    print(f"timing: avg tick {timing.avg_tick_ms:.2f} ms "
          f"(budget {1000.0 * cfg.optimization_stride / cfg.hz:.0f} ms)")
    print(f"laps: {len(out['laps'].laps)}  controls published: "
          f"{len(plant.published)}")
    print(f"final state: pos=({plant.true_state[0]:.2f},"
          f"{plant.true_state[1]:.2f}) speed={plant.true_state[4]:.2f}")
    if tuner is not None:
        print(f"ess tuner: target ESS {tuner.target:.0f}, gamma "
              f"{tuner.base:.4g} -> {tuner.gamma:.4g}")


if __name__ == "__main__":
    main()
