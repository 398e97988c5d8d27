"""Model evaluation: instantaneous and multi-step closed-loop errors (port
of ``autorally_tpu/ml/evaluate.py``).

Port of ``generate_predictions`` (``train_dynamics_model.py:156-347``): the
decisive metric for an MPPI dynamics model is not one-step loss but how far
closed-loop rollouts drift from ground truth over the control horizon.
Given a logged trajectory, every index starts an H-step rollout integrated
with the trained model (full kinematics + dynamics, matching
``compute_state_ders``, ``utils.py:132-152``), and errors are aggregated
per horizon step.  The JAX ``vmap`` of a ``lax.scan`` is H batched steps
over all (N, S) start points at once, on the device of ``params``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from autorally_tpu_torch.ml.train import full_float32, predict
from autorally_tpu_torch.models.base import Dynamics


def _device(params) -> torch.device:
    return params["control_rngs"].device


def instantaneous_errors(model: Dynamics, params, inputs: np.ndarray,
                         labels: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-output one-step prediction errors (pred - label)."""
    x = torch.as_tensor(np.asarray(inputs, np.float32), device=_device(params))
    with torch.no_grad(), full_float32():
        preds = predict(model, params, x).cpu().numpy()
    err = preds - labels
    return {
        "errors": err,
        "mean_abs": np.abs(err).mean(axis=0),
        "rmse": np.sqrt((err ** 2).mean(axis=0)),
    }


def multistep_errors(model: Dynamics, params, states: np.ndarray,
                     controls: np.ndarray, horizon: int
                     ) -> Dict[str, np.ndarray]:
    """Closed-loop rollout error vs horizon.

    ``states``: (N, 7) ground-truth trajectory at the model dt;
    ``controls``: (N, 2) executed controls.  From every start index i the
    model is rolled ``horizon`` steps against controls[i:i+H], and compared
    to states[i+1:i+1+H].  Returns per-horizon-step position and full-state
    error statistics (the reference's boxplot data,
    train_dynamics_model.py:250-330).
    """
    N = len(states) - horizon
    if N <= 0:
        raise ValueError("trajectory shorter than horizon")
    dev = _device(params)
    idx = np.arange(N)[:, None] + np.arange(horizon)[None, :]
    ctrl = torch.as_tensor(np.asarray(controls, np.float32)[idx],
                           device=dev)                    # (N, H, C)
    s = torch.as_tensor(np.asarray(states[:N], np.float32), device=dev)
    traj = []
    with torch.no_grad(), full_float32():
        for h in range(horizon):
            u = model.enforce_constraints(params, ctrl[:, h])
            s = s + model.state_deriv(params, s, u) * model.dt
            traj.append(s)
    trajs = torch.stack(traj, dim=1).cpu().numpy()        # (N, H, S)
    err = trajs - states[idx + 1]                         # (N, H, S)
    pos_err = np.linalg.norm(err[..., :2], axis=-1)       # (N, H)
    return {
        "state_errors": err,
        "pos_error_mean": pos_err.mean(axis=0),           # (H,)
        "pos_error_median": np.median(pos_err, axis=0),
        "pos_error_p90": np.percentile(pos_err, 90, axis=0),
        "state_rmse": np.sqrt((err ** 2).mean(axis=0)),   # (H, S)
    }
