"""Dynamics-model training: Adam + weighted smooth-L1, best-val
checkpointing (port of ``autorally_tpu/ml/train.py``).

Re-design of ``ml_pipeline/train_dynamics_model.py:16-153``: the trained
object is the :class:`NeuralNetDynamics` params dict, so the result feeds
the MPPI solver with zero conversion; ``save_params`` exports the
reference ``.npz`` interchange.

Defaults mirror ``config.yml``: Adam lr 5e-3, batch 64, smooth-L1 with
per-output loss weights [1, 1, 1, 0.5].  The optimizers are
``torch.optim.Adam`` and, with weight decay, ``AdamW``: the update of
``optax.adam`` / ``optax.adamw`` (eps outside the square root, bias
correction, decoupled decay).  The batches are the JAX package's
(``DynamicsDataset.batches`` draws them with numpy), the products float32
without TF32 at every ``MPPIConfig.matmul_precision``: that knob reaches
only the solver's rollout kernels, and the JAX trainer takes none.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from autorally_tpu_torch.ml.dataset import DynamicsDataset
from autorally_tpu_torch.models.neural_net import NeuralNetDynamics


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 50
    batch_size: int = 64
    lr: float = 5e-3
    weight_decay: float = 0.0
    loss_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 0.5)
    seed: int = 0
    log_every: int = 10


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (torch SmoothL1Loss semantics, beta=1):
    0.5 x^2 for |x| < 1 else |x| - 0.5."""
    d = torch.abs(pred - target)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def weighted_loss(pred: torch.Tensor, target: torch.Tensor,
                  weights) -> torch.Tensor:
    """The reference scales outputs AND labels by the loss weights before
    the criterion (train_dynamics_model.py:81-83); a float32 mean."""
    w = torch.as_tensor(weights, dtype=pred.dtype, device=pred.device)
    return torch.mean(smooth_l1(pred * w, target * w))


def predict(model: NeuralNetDynamics, params, x: torch.Tensor
            ) -> torch.Tensor:
    """The model's own forward pass (``dynamics``) on inputs ``x`` (N, 6):
    the dynamics states, then the controls."""
    D = model.DYNAMICS_DIM
    states = torch.nn.functional.pad(x[:, :D], (model.KINEMATICS_DIM, 0))
    return model.dynamics(params, states, x[:, D:])


@contextlib.contextmanager
def full_float32():
    """float32 products without TF32 for the block (restored after)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def train_dynamics(model: NeuralNetDynamics, params, train: DynamicsDataset,
                   val: DynamicsDataset, cfg: TrainConfig = TrainConfig(),
                   verbose: bool = True) -> Tuple[Dict, Dict]:
    """Train the MLP on the device of ``params``; returns (best_params,
    history {"train": [...], "val": [...]} of per-epoch losses).

    Only ``weights``/``biases`` train; ``control_rngs`` rides along
    untouched (it is configuration, not a parameter).
    """
    dev = params["weights"][0].device
    n = len(params["weights"])
    leaves = [t.detach().clone().to(torch.float32).requires_grad_(True)
              for t in (*params["weights"], *params["biases"])]
    wb = {**params, "weights": leaves[:n], "biases": leaves[n:]}
    if cfg.weight_decay > 0:
        opt = torch.optim.AdamW(leaves, lr=cfg.lr,
                                weight_decay=cfg.weight_decay)
    else:
        opt = torch.optim.Adam(leaves, lr=cfg.lr)
    val_x = torch.as_tensor(val.inputs, dtype=torch.float32, device=dev)
    val_y = torch.as_tensor(val.labels, dtype=torch.float32, device=dev)

    best_val = np.inf
    best = [t.detach().clone() for t in leaves]
    history = {"train": [], "val": []}
    with full_float32():
        for epoch in range(cfg.epochs):
            losses = []
            for x, y in train.batches(cfg.batch_size, seed=cfg.seed + epoch):
                x = torch.as_tensor(x, dtype=torch.float32, device=dev)
                y = torch.as_tensor(y, dtype=torch.float32, device=dev)
                loss = weighted_loss(predict(model, wb, x), y,
                                     cfg.loss_weights)
                opt.zero_grad()
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            # one read of the epoch's losses, summed in float64 as the JAX
            # loop sums its float(loss)
            train_loss = (float(torch.stack(losses).double().sum())
                          / len(losses) if losses else 0.0)
            with torch.no_grad():
                val_loss = float(weighted_loss(predict(model, wb, val_x),
                                               val_y, cfg.loss_weights))
            history["train"].append(train_loss)
            history["val"].append(val_loss)

            # best-validation checkpointing (train_dynamics_model.py:115-120)
            if val_loss < best_val:
                best_val = val_loss
                best = [t.detach().clone() for t in leaves]

            if verbose and (epoch % cfg.log_every == 0
                            or epoch == cfg.epochs - 1):
                print(f"epoch {epoch:4d}  train {train_loss:.5f}  "
                      f"val {val_loss:.5f}  best {best_val:.5f}")

    best_params = {**params, "weights": best[:n], "biases": best[n:]}
    return best_params, history


def fold_standardization(params, feat_mean, feat_std, label_mean,
                         label_std):
    """Fold feature/label standardization into the first/last layers.

    The reference trains on StandardScaler-transformed data and must
    carry the scaler pickles to inference (``trainer.py:120-133``,
    config.yml NOTE #2: forgetting them silently breaks predictions).
    Folding the affine transforms into the weights instead produces a
    raw-space model: with the framework's ``acts @ W`` convention,

        W0' = W0 / s_f[:, None],      b0' = b0 - (m_f / s_f) @ W0
        WL' = WL * s_l[None, :],      bL' = bL * s_l + m_l

    so ``NN'(x) == unstandardize(NN(standardize(x)))`` to float32 rounding
    and the exported ``.npz`` drops into the controller with no side
    files."""
    dev = params["weights"][0].device

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32) if not
                               torch.is_tensor(a) else a,
                               dtype=torch.float32, device=dev)

    W = [f32(w) for w in params["weights"]]
    b = [f32(x) for x in params["biases"]]
    fm, fs = f32(feat_mean), f32(feat_std)
    lm, ls = f32(label_mean), f32(label_std)
    b[0] = b[0] - (fm / fs) @ W[0]
    W[0] = W[0] / fs[:, None]
    b[-1] = b[-1] * ls + lm
    W[-1] = W[-1] * ls[None, :]
    return {**params, "weights": W, "biases": b}
