"""``torch.nn`` interchange for dynamics models (port of
``autorally_tpu/ml/torch_interop.py``).

The reference trains in PyTorch and ships ``.npz`` to the controller
(``ml_pipeline/utils.py:49-90``: ``npz_to_torch_model`` /
``torch_model_to_npz``, float64 npz as the canonical format, plus
``setup_model:16-46`` building the tanh MLP).  Teams with existing torch
models and checkpoints (e.g. ``torch_model_autorally_nnet.pt``) cross in
both directions:

- an ``nn.Sequential`` or a ``.pt`` state dict -> the
  :class:`NeuralNetDynamics` params dict (weights (in, out), float32, on
  the model's device), which drops straight into the solver;
- a params dict -> the reference's float64 ``nn.Sequential``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from autorally_tpu_torch.models.neural_net import NeuralNetDynamics


def setup_torch_model(layers: Sequence[int] = (6, 32, 32, 4)
                      ) -> torch.nn.Sequential:
    """The reference's MLP builder (``utils.py:16-46``): Linear+Tanh pairs
    with a linear output layer, float64 like the reference pipeline."""
    mods = []
    for i in range(len(layers) - 2):
        mods.append(torch.nn.Linear(layers[i], layers[i + 1]))
        mods.append(torch.nn.Tanh())
    mods.append(torch.nn.Linear(layers[-2], layers[-1]))
    return torch.nn.Sequential(*mods).double()


def _params(model: NeuralNetDynamics, pairs) -> dict:
    """The params dict of (out, in) weight / bias array pairs, checked
    against ``model.layers``; ``control_rngs`` the model's ranges."""
    pairs = list(pairs)
    if len(pairs) != len(model.layers) - 1:
        raise ValueError(
            f"module has {len(pairs)} Linear layers; model expects "
            f"{len(model.layers) - 1}")
    weights, biases = [], []
    for (name, W, b), (fi, fo) in zip(pairs, zip(model.layers,
                                                  model.layers[1:])):
        W = np.asarray(W, dtype=np.float32)
        if W.shape != (fo, fi):
            raise ValueError(f"{name}: shape {W.shape} != ({fo}, {fi})")
        weights.append(model._tensor(np.ascontiguousarray(W.T)))
        biases.append(model._tensor(np.asarray(b, np.float32).reshape(-1)))
    return {"weights": weights, "biases": biases,
            "control_rngs": model._tensor(model._control_ranges)}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def torch_to_params(module, model: NeuralNetDynamics) -> dict:
    """torch module -> NeuralNetDynamics params dict (weights stored
    (in, out) for the batched forward)."""
    linears = [m for m in module if isinstance(m, torch.nn.Linear)]
    return _params(model, ((f"layer {i}", _host(m.weight), _host(m.bias))
                           for i, m in enumerate(linears)))


def params_to_torch(params: dict, model: NeuralNetDynamics
                    ) -> torch.nn.Sequential:
    """params dict -> torch module (float64, reference convention)."""
    module = setup_torch_model(model.layers)
    linears = [m for m in module if isinstance(m, torch.nn.Linear)]
    with torch.no_grad():
        for lin, W, b in zip(linears, params["weights"], params["biases"]):
            lin.weight.copy_(torch.as_tensor(W).double().T)
            lin.bias.copy_(torch.as_tensor(b).double())
    return module


def load_torch_checkpoint(path: str, model: NeuralNetDynamics) -> dict:
    """Load a reference ``.pt`` checkpoint (either a bare module or the
    trainer's ``{'model_state_dict': ...}`` dict,
    train_dynamics_model.py:115-120) into a params dict."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if isinstance(obj, dict):
        # accept any naming scheme (the reference .pt uses nn0/nn1/nn2):
        # pair up *.weight / *.bias in key order
        wkeys = [k for k in obj if k.endswith(".weight")]
        return _params(model, ((k, _host(obj[k]),
                                _host(obj[k[:-len(".weight")] + ".bias"]))
                               for k in wkeys[:len(model.layers) - 1]))
    return torch_to_params(obj, model)
