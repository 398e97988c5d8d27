"""NN-vs-analytic-ODE sanity comparison + ground-truth sensor noise stats
(port of ``autorally_tpu/ml/ode_compare.py``).

- :func:`analytic_vehicle_ode` / :func:`compare_nn_to_ode` — the
  ``model_vehicle_dynamics.py:37-162`` cross-check: propagate the learned
  model and a simple analytic ODE (``du_x = a2*throttle``, ``dyaw_rate =
  a1*steering``, kinematic position/yaw) under fixed or ramped controls
  and report their divergence.  A trained model that disagrees wildly
  with the analytic skeleton on straight-line maneuvers is broken.
- :func:`sensor_noise_stats` — the ``ssl_vision/sensor_noise.py`` role:
  quantify a ground-truth rig's noise from a log captured with the
  vehicle stationary (per-channel std/peak-to-peak).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def analytic_vehicle_ode(state: np.ndarray, steering: float, throttle: float,
                         a1: float = -1.0, a2: float = 5.0) -> np.ndarray:
    """First-order vehicle EOM skeleton (model_vehicle_dynamics.py:37-48):
    kinematics + linear throttle->accel and steering->yaw-accel; roll and
    lateral velocity ignored."""
    return np.array([
        np.cos(state[2]) * state[4] - np.sin(state[2]) * state[5],
        np.sin(state[2]) * state[4] + np.cos(state[2]) * state[5],
        -state[6],
        0.0,
        a2 * throttle,
        0.0,
        a1 * steering,
    ])


def compare_nn_to_ode(model, params, steering: float, throttle: float,
                      time_horizon: float, dt: float = 0.01,
                      init_cond: Optional[np.ndarray] = None,
                      linear_varying_ctrls: bool = False,
                      a1: float = -1.0, a2: float = 5.0
                      ) -> Dict[str, np.ndarray]:
    """Propagate the learned model (``update_state``, on the device of
    ``params``) and the analytic ODE side by side
    (``model_vehicle_dynamics``): returns both trajectories and their
    final-state divergence."""
    dev = params["control_rngs"].device
    n = int(time_horizon / dt)
    s_nn = np.zeros(7, dtype=np.float32) if init_cond is None \
        else np.asarray(init_cond, dtype=np.float32).copy()
    s_ode = s_nn.copy().astype(np.float64)
    traj_nn = np.zeros((n, 7), dtype=np.float32)
    traj_ode = np.zeros((n, 7), dtype=np.float64)
    ctrls = np.zeros((n, 2), dtype=np.float32)
    s = torch.as_tensor(s_nn, device=dev)
    for i in range(n):
        if linear_varying_ctrls:           # ramp 0 -> target (:106-112)
            u = np.array([steering, throttle]) * (i + 1) / n
        else:
            u = np.array([steering, throttle])
        ctrls[i] = u
        traj_ode[i] = s_ode
        with torch.no_grad():
            s_next, _ = model.update_state(
                params, s, torch.as_tensor(u, dtype=torch.float32,
                                           device=dev))
        traj_nn[i] = s.cpu().numpy()
        s = s_next
        s_ode = s_ode + analytic_vehicle_ode(s_ode, u[0], u[1], a1, a2) * dt
    return {
        "nn": traj_nn, "ode": traj_ode, "controls": ctrls,
        "final_divergence": np.abs(traj_nn[-1] - traj_ode[-1]),
    }


def sensor_noise_stats(log: np.ndarray,
                       channel_names: Optional[Tuple[str, ...]] = None
                       ) -> Dict[str, Dict[str, float]]:
    """Noise statistics of a stationary ground-truth log
    (``ssl_vision/sensor_noise.py`` role): per channel std, peak-to-peak,
    and drift (first-to-last delta)."""
    log = np.asarray(log, dtype=np.float64)
    if log.ndim == 1:
        log = log[:, None]
    names = (channel_names or
             tuple(f"ch{i}" for i in range(log.shape[1])))
    out = {}
    for i, name in enumerate(names):
        x = log[:, i]
        out[name] = {
            "std": float(x.std()),
            "peak_to_peak": float(x.max() - x.min()),
            "drift": float(x[-1] - x[0]),
        }
    return out
