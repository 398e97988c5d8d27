"""Fully-connected tanh MLP dynamics (port of
``autorally_tpu/models/neural_net.py``; reference ``NeuralNetModel``,
``neural_net_model.cuh:48-132``).

Input to the net (``neural_net_model.cu:372-377``)::

    acts = [roll, u_x, u_y, yaw_der, steering, throttle]   # (D + C = 6)

Output: d/dt of [roll, u_x, u_y, yaw_der].  The module holds its current
weights ((in, out) matrices, biases, ``control_rngs``); every dynamics
method also takes a params dict in the JAX package's layout, which
:meth:`NeuralNetDynamics.params` returns for the held weights.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from autorally_tpu_torch.models.base import Dynamics, Params


class NeuralNetDynamics(Dynamics):
    """MLP dynamics; ``layers`` mirrors the reference template spec, e.g.
    ``NeuralNetModel<7,2,3,6,32,32,4>`` -> ``layers=(6, 32, 32, 4)``."""

    def __init__(self, dt: float, layers: Sequence[int] = (6, 32, 32, 4),
                 control_ranges=((-0.99, 0.99), (-0.99, 0.65)),
                 negate_yaw_der: bool = True, device=None):
        super().__init__(dt, negate_yaw_der, device)
        self.layers = tuple(int(n) for n in layers)
        if self.layers[0] != self.DYNAMICS_DIM + self.CONTROL_DIM:
            raise ValueError(
                f"first layer must be {self.DYNAMICS_DIM + self.CONTROL_DIM}, "
                f"got {self.layers[0]}")
        if self.layers[-1] != self.DYNAMICS_DIM:
            raise ValueError(
                f"last layer must be {self.DYNAMICS_DIM}, got {self.layers[-1]}")
        self._control_ranges = control_ranges
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        self.register_buffer("control_rngs", self._tensor(control_ranges))

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float32),
                            device=self.device)

    def _hold(self, weights, biases, control_rngs) -> Params:
        """Make the given (in, out) weights, biases and ranges the held
        ones and return them as a params dict."""
        frozen = lambda t: nn.Parameter(self._tensor(t), requires_grad=False)
        self.weights = nn.ParameterList([frozen(w) for w in weights])
        self.biases = nn.ParameterList([frozen(b) for b in biases])
        self.control_rngs = self._tensor(control_rngs)
        return self.params()

    def params(self) -> Params:
        """The held weights as a params dict (shares their storage)."""
        return {"weights": list(self.weights), "biases": list(self.biases),
                "control_rngs": self.control_rngs}

    # -- parameters ---------------------------------------------------------

    def init_params(self, seed: int) -> Params:
        """Glorot-normal init from a numpy seed, zero biases."""
        rng = np.random.default_rng(seed)
        weights, biases = [], []
        for fan_in, fan_out in zip(self.layers[:-1], self.layers[1:]):
            scale = np.sqrt(2.0 / (fan_in + fan_out))
            weights.append(scale * rng.standard_normal((fan_in, fan_out)))
            biases.append(np.zeros((fan_out,)))
        return self._hold(weights, biases, self._control_ranges)

    def params_from_jax(self, params_np) -> Params:
        """Carry the JAX package's params pytree over, given as numpy arrays
        ``{"weights": [(in, out)], "biases": [(out,)], "control_rngs":
        (C, 2)}``, so that both packages compute the same function."""
        return self._hold(params_np["weights"], params_np["biases"],
                          params_np["control_rngs"])

    @classmethod
    def from_npz(cls, path: str, dt: float,
                 control_ranges=((-0.99, 0.99), (-0.99, 0.65)),
                 negate_yaw_der: bool = True, device=None):
        """A model whose layer spec is inferred from the ``.npz``, with its
        params loaded: ``(model, params)``.  The spec comes from element
        counts (a bias's size is its layer's fan-out), so flat or oddly
        shaped weight arrays, which :meth:`load_params` reshapes, infer the
        spec it loads (e.g. 6-64-64-64-64-4, which kernels 1 and 2 run
        from a library built for it at first use)."""
        data = np.load(path)
        layers = []
        i = 1
        while f"dynamics_W{i}" in data.files:
            out = int(np.asarray(data[f"dynamics_b{i}"]).size)
            if not layers:
                layers.append(
                    int(np.asarray(data[f"dynamics_W{i}"]).size) // out)
            layers.append(out)
            i += 1
        model = cls(dt, layers=layers, control_ranges=control_ranges,
                    negate_yaw_der=negate_yaw_der, device=device)
        return model, model.load_params(path)

    def load_params(self, path: str) -> Params:
        """Load ``dynamics_W{i}/b{i}`` from the reference ``.npz`` (float64
        (out, in) -> float32 (in, out)), as ``neural_net_model.cu:73-106``."""
        data = np.load(path)
        weights, biases = [], []
        for i in range(1, len(self.layers)):
            W = np.asarray(data[f"dynamics_W{i}"], dtype=np.float32)
            b = np.asarray(data[f"dynamics_b{i}"], dtype=np.float32).reshape(-1)
            W = W.reshape(self.layers[i], self.layers[i - 1])
            weights.append(W.T)
            biases.append(b)
        return self._hold(weights, biases, self._control_ranges)

    def save_params(self, params: Params, path: str) -> None:
        """Export to the reference ``.npz`` format (float64, (out, in))."""
        out = {}
        for i, (W, b) in enumerate(zip(params["weights"], params["biases"])):
            out[f"dynamics_W{i + 1}"] = W.detach().cpu().double().numpy().T
            out[f"dynamics_b{i + 1}"] = b.detach().cpu().double().numpy()
        np.savez(path, **out)

    def update_model(self, params: Params, description: Sequence[int],
                     flat_data) -> Params:
        """Hot-swap the weights from a flat buffer (the reference's live
        ``neuralNetModel`` topic, ``neural_net_model.cu:152-180``): every
        weight matrix first, row-major (out, in), then every bias.  Returns
        new params with the other entries of ``params`` kept, or ``params``
        itself when ``description`` is not this model's layer spec.  The
        held weights are left as they are.  The kernels' packed weights
        follow the new tensors (``rollout_kernel._pack_weights`` keys its
        cache on them)."""
        if tuple(int(n) for n in description) != self.layers:
            return params
        flat = np.asarray(flat_data, dtype=np.float32).reshape(-1)
        weights, biases = [], []
        stride = 0
        for fan_in, fan_out in zip(self.layers[:-1], self.layers[1:]):
            W = flat[stride:stride + fan_out * fan_in].reshape(fan_out, fan_in)
            weights.append(self._tensor(np.ascontiguousarray(W.T)))
            stride += fan_out * fan_in
        for fan_out in self.layers[1:]:
            biases.append(self._tensor(flat[stride:stride + fan_out]))
            stride += fan_out
        return {**params, "weights": weights, "biases": biases}

    @property
    def num_params(self) -> int:
        return sum(a * b + b for a, b in zip(self.layers[:-1], self.layers[1:]))

    # -- in-kernel form (ops/rollout_kernel.py) ------------------------------

    KERNEL_KIND = "mlp"

    def kernel_weights(self, params: Params) -> list:
        """(out, in) weight panels + (out, 1) bias columns, the layout of
        the JAX package's kernels and of the CUDA kernels' packed buffer."""
        wb = []
        for W, b in zip(params["weights"], params["biases"]):
            wb.append(W.t())
            wb.append(b[:, None])
        return wb

    # -- forward ------------------------------------------------------------

    def dynamics(self, params: Params, states: torch.Tensor,
                 controls: torch.Tensor) -> torch.Tensor:
        """Batched MLP forward pass (tanh hidden, linear output), in full
        fp32 (``neural_net_model.cu:358-410``)."""
        acts = torch.cat([states[..., self.KINEMATICS_DIM:], controls], dim=-1)
        n = len(params["weights"])
        for i, (W, b) in enumerate(zip(params["weights"], params["biases"])):
            acts = acts @ W + b
            if i < n - 1:
                acts = torch.tanh(acts)
        return acts

    def forward(self, states: torch.Tensor,
                controls: torch.Tensor) -> torch.Tensor:
        """Full state derivative with the held weights."""
        return self.state_deriv(self.params(), states, controls)
