"""Controller-state checkpoint and resume (port of
``autorally_tpu/io/checkpoint.py``).

The reference controller has no checkpointing: a restart is its recovery,
because its state is only the 2 s control horizon.  Here the
:class:`ControllerState` (plan, control history, solutions and the key)
round-trips through ``.npz``, so a controller process can resume mid-plan
after a crash or move to another host.  The format is the JAX package's,
field for field, the key as its two uint32 words: a file saved by either
package loads into the other.
"""

from __future__ import annotations

import numpy as np
import torch

from autorally_tpu_torch.config import resolve_device
from autorally_tpu_torch.solver.mppi import ControllerState


def _flatten(cs: ControllerState, prefix: str = "") -> dict:
    """One convention for every checkpoint here, driven by ``_fields``: a
    new ``ControllerState`` field is carried by every saver or by none."""
    return {prefix + f: (v.detach().cpu().numpy() if torch.is_tensor(v)
                         else np.asarray(v))
            for f, v in cs._asdict().items()}


def _unflatten(d, prefix: str, device) -> ControllerState:
    dev = resolve_device(device)
    fields = {f: torch.tensor(np.asarray(d[prefix + f], np.float32),
                              device=dev)
              for f in ControllerState._fields if f != "key"}
    return ControllerState(**fields,
                           key=np.asarray(d[prefix + "key"], np.uint32))


def save_controller_state(cs: ControllerState, path: str) -> None:
    np.savez(path, **_flatten(cs))


def load_controller_state(path: str, device=None) -> ControllerState:
    """The state saved at ``path``, its tensors on ``device`` (``cuda``
    unless given)."""
    with np.load(path) as d:
        return _unflatten(d, "", device)


def _tube_pair(tube):
    """Accepts an ``AsyncTubeController`` (``cs_a``/``cs_p``), a pair of
    ``Controller`` objects (the sequential loop's actual and predicted,
    each owning ``.cs``), or a pair of raw :class:`ControllerState`."""
    if hasattr(tube, "cs_a"):
        return tube.cs_a, tube.cs_p
    a, p = tube
    return (a.cs if hasattr(a, "cs") else a), (p.cs if hasattr(p, "cs") else p)


def save_tube_state(tube, path: str) -> None:
    """Checkpoint a tube pair, both controllers' states in one ``.npz``
    (see :func:`_tube_pair` for what ``tube`` may be)."""
    cs_a, cs_p = _tube_pair(tube)
    np.savez(path, **_flatten(cs_a, "a_"), **_flatten(cs_p, "p_"))


def load_tube_state(path: str, device=None):
    """-> (cs_actual, cs_predicted) from :func:`save_tube_state`, their
    tensors on ``device`` (``cuda`` unless given)."""
    with np.load(path) as d:
        return _unflatten(d, "a_", device), _unflatten(d, "p_", device)
