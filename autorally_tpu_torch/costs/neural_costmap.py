"""Neural costmap: the track surface as a Fourier-feature MLP field (port of
``autorally_tpu/costs/neural_costmap.py``).

The field approximates channel 0 of the exact point-sampled
:class:`~autorally_tpu_torch.costs.costmap.Costmap`; the exact map stays the
default.  :func:`fit_neural_costmap` distils a map into a field and reports
the approximation quality, including the fraction of pixels whose
crash-boundary classification (``value >= boundary_threshold``,
``costs.cu:389-391``) flips.

Duck-typed against ``Costmap``: it implements ``world_to_norm``,
``lookup_ch0`` (what ``MPPICost.track_cost_c`` samples), ``lookup`` and the
host ``transform`` the CUDA kernels' launch scalars read.  On the GPU the
rollout kernels evaluate the field themselves (``csrc/rollout_kernels.cu``,
``FieldLookup``), at any spec and from float32 or bf16 weights (upcast to
float32, as the JAX kernels upcast them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from autorally_tpu_torch.config import resolve_device


@dataclasses.dataclass(frozen=True)
class NeuralCostmap:
    """Fourier-feature ReLU MLP over normalized map coordinates.

    ``weights``: ((in, out), ...) float32 or bfloat16; ``biases``:
    ((out,), ...) float32;
    ``freqs``: (F,) Fourier frequencies (powers of 2 times pi); ``r_c1``,
    ``r_c2``, ``trs``: (3,) columns of the projective world->map transform;
    ``transform``: those nine float32 values on the host, ``r_c1 + r_c2 +
    trs``, as ``Costmap.transform``."""

    weights: tuple
    biases: tuple
    freqs: torch.Tensor
    r_c1: torch.Tensor
    r_c2: torch.Tensor
    trs: torch.Tensor
    transform: Tuple[float, ...]

    @property
    def layers(self) -> Tuple[int, ...]:
        """The layer widths, e.g. (34, 64, 64, 1) for F=8, hidden (64, 64)."""
        return (self.weights[0].shape[0],) + tuple(w.shape[1]
                                                   for w in self.weights)

    @property
    def device(self) -> torch.device:
        return self.freqs.device

    @property
    def dtype(self) -> torch.dtype:
        """The weights' dtype: float32 or bfloat16."""
        return self.weights[0].dtype

    @classmethod
    def build(cls, weights, biases, freqs, r_c1, r_c2, trs, device=None,
              dtype=torch.float32) -> "NeuralCostmap":
        """Construct from arrays ((in, out) weights) on ``device``, the
        weights in ``dtype`` (float32 or bfloat16), the rest float32."""
        dev = resolve_device(device)
        as_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float32),
                                      device=dev)
        cols = [np.asarray(c, dtype=np.float32) for c in (r_c1, r_c2, trs)]
        return cls(tuple(as_t(w).to(dtype) for w in weights),
                   tuple(as_t(b) for b in biases), as_t(freqs),
                   *(as_t(c) for c in cols),
                   tuple(float(v) for c in cols for v in c))

    @classmethod
    def from_jax(cls, field, device=None) -> "NeuralCostmap":
        """Carry the JAX package's ``NeuralCostmap`` over, given with numpy
        arrays (``jax.tree_util.tree_map(np.asarray, field)``), so that both
        packages evaluate the same function: float32 weights, or bfloat16
        weights (ml_dtypes' ``bfloat16``) carried bit for bit; another
        dtype raises."""
        names = {np.asarray(w).dtype.name for w in field.weights}
        if len(names) != 1 or names - {"float32", "bfloat16"}:
            raise TypeError(f"field weights of dtype {sorted(names)}: a "
                            "NeuralCostmap holds float32 or bfloat16 "
                            "weights")
        # bfloat16 values are exact in float32, so the cast back is exact
        return cls.build([np.asarray(w).astype(np.float32)
                          for w in field.weights], field.biases,
                         field.freqs, field.r_c1, field.r_c2, field.trs,
                         device=device, dtype=(torch.bfloat16 if names == {
                             "bfloat16"} else torch.float32))

    def to_float32(self) -> "NeuralCostmap":
        """The field with its weights in float32 (itself when they are):
        what the CUDA kernels evaluate, as the JAX kernels upcast a bf16
        field's layers before their launch."""
        if self.dtype == torch.float32:
            return self
        return dataclasses.replace(self, weights=tuple(
            w.to(torch.float32) for w in self.weights))

    def world_to_norm(self, x: torch.Tensor, y: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        u = self.r_c1[0] * x + self.r_c2[0] * y + self.trs[0]
        v = self.r_c1[1] * x + self.r_c2[1] * y + self.trs[1]
        w = self.r_c1[2] * x + self.r_c2[2] * y + self.trs[2]
        return u / w, v / w

    def _features(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Fourier encoding (N,) -> (N, 4F+2) in the JAX block order
        ``[u, v, sin(uF), sin(vF), cos(uF), cos(vF)]``; each angle is one
        float32 product."""
        ang_u = u[:, None] * self.freqs
        ang_v = v[:, None] * self.freqs
        return torch.cat([u[:, None], v[:, None], torch.sin(ang_u),
                          torch.sin(ang_v), torch.cos(ang_u),
                          torch.cos(ang_v)], dim=1)

    def forward_norm(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The field at normalized coordinates (N,) -> (N,): ReLU hidden
        layers, linear output, full fp32."""
        acts = self._features(u, v)
        n = len(self.weights)
        for i, (W, b) in enumerate(zip(self.weights, self.biases)):
            acts = acts @ W + b
            if i < n - 1:
                acts = torch.relu(acts)
        return acts[:, 0]

    def lookup_ch0(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Approximate channel 0 at world (x, y): (...,) -> (...,).  The
        normalized coordinates are clipped to [0, 1], then NaN -> 0.  A
        bf16 field follows the JAX ``lookup_ch0``'s casts: the features in
        bf16, each layer a float32 product of the bf16 values plus the
        float32 bias, the ReLU, the result back to bf16; float32 at the
        end."""
        u, v = self.world_to_norm(x, y)
        u = torch.nan_to_num(torch.clamp(u, 0.0, 1.0))
        v = torch.nan_to_num(torch.clamp(v, 0.0, 1.0))
        shape = u.shape
        u, v = u.reshape(-1), v.reshape(-1)
        if self.dtype == torch.float32:
            out = self.forward_norm(u, v)
        else:
            acts = self._features(u, v).to(self.dtype)
            n = len(self.weights)
            for i, (W, b) in enumerate(zip(self.weights, self.biases)):
                acts = acts.to(torch.float32) @ W.to(torch.float32) + b
                if i < n - 1:
                    acts = torch.relu(acts)
                acts = acts.to(W.dtype)
            out = acts[:, 0].to(torch.float32)
        return out.reshape(shape)

    def lookup(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """4-channel interface: channel 0 learned, the rest zero."""
        ch0 = self.lookup_ch0(x, y)
        zero = torch.zeros_like(ch0)
        return torch.stack([ch0, zero, zero, zero], dim=-1)


def fit_neural_costmap(costmap, hidden: Tuple[int, ...] = (64, 64),
                       num_freqs: int = 8, epochs: int = 4000,
                       batch: int = 16384, lr: float = 2e-3,
                       boundary_threshold: float = 0.65,
                       dtype=torch.float32, seed: int = 0,
                       device=None, verbose: bool = False
                       ) -> Tuple[NeuralCostmap, Dict[str, float]]:
    """Distil ``costmap`` channel 0 into a :class:`NeuralCostmap` on
    ``device`` (``cuda`` unless given): He-normal weights and zero biases
    from ``seed``, ``epochs`` Adam steps (optax's defaults) on mean squared
    error over ``batch`` pixel centres drawn uniformly, with targets capped
    at ``max(3, 3 * boundary_threshold)``; the fitted weights are cast to
    ``dtype`` at the end (float32 or bfloat16; the biases stay float32), as
    the JAX fit casts them.

    Returns (field, metrics) with ``mae`` and ``max_err`` over the
    uncapped pixels and ``boundary_flip_rate``, the fraction of pixels
    within 1 of the threshold whose crash classification changes."""
    dev = resolve_device(device)
    H, W = costmap.height, costmap.width
    ch0 = costmap.data[..., 0].detach().cpu().numpy()
    vs = (np.arange(H) + 0.5) / H
    us = (np.arange(W) + 0.5) / W
    UU, VV = np.meshgrid(us, vs)
    coords = np.stack([UU.reshape(-1), VV.reshape(-1)], axis=1).astype(
        np.float32)
    cap = max(3.0, boundary_threshold * 3)
    targets = np.minimum(ch0.reshape(-1, 1), cap).astype(np.float32)

    freqs = torch.tensor((2.0 ** np.arange(num_freqs)) * np.pi,
                         dtype=torch.float32, device=dev)
    layers = (2 + 4 * num_freqs,) + tuple(hidden) + (1,)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    weights = [(np.sqrt(2.0 / a) * torch.randn(
        (a, b), generator=gen, device=dev)).requires_grad_()
        for a, b in zip(layers[:-1], layers[1:])]
    biases = [torch.zeros(b, device=dev, requires_grad=True)
              for b in layers[1:]]
    r_c1, r_c2, trs = (c.to(dev) for c in (costmap.r_c1, costmap.r_c2,
                                           costmap.trs))

    field = lambda ws, bs: NeuralCostmap(tuple(ws), tuple(bs), freqs, r_c1,
                                         r_c2, trs, tuple(costmap.transform))

    coords_d = torch.as_tensor(coords, device=dev)
    targets_d = torch.as_tensor(targets, device=dev)
    opt = torch.optim.Adam(weights + biases, lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    model = field(weights, biases)
    first = last = None
    for _ in range(epochs):
        idx = torch.randint(0, len(coords), (batch,), generator=gen,
                            device=dev)
        p = coords_d[idx]
        loss = torch.mean((model.forward_norm(p[:, 0], p[:, 1])
                           - targets_d[idx, 0]) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        first = loss.detach() if first is None else first
        last = loss.detach()
    if verbose and epochs:
        print(f"  nc fit: loss {float(first):.5f} -> {float(last):.5f} "
              f"over {epochs} steps")

    fitted = field([w.detach() for w in weights],
                   [b.detach() for b in biases])
    cast = dataclasses.replace(fitted, weights=tuple(
        w.to(dtype) for w in fitted.weights))
    with torch.no_grad():
        pred = torch.cat([fitted.forward_norm(c[:, 0], c[:, 1]) for c in
                          coords_d.split(1 << 18)]).cpu().numpy()
    true = targets.reshape(-1)
    on_track = true < cap - 1e-3          # exclude the capped plateau
    err = np.abs(pred - true)
    flips = (pred >= boundary_threshold) != (true >= boundary_threshold)
    near = np.abs(true - boundary_threshold) < 1.0
    metrics = {"mae": float(err[on_track].mean()),
               "max_err": float(err[on_track].max()),
               "boundary_flip_rate": float(flips[near].mean())}
    return cast, metrics
