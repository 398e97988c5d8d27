"""Dataset preparation for dynamics-model training (port of
``autorally_tpu/ml/dataset.py``).

Covers the reference preprocessing stage (``ml_pipeline/preprocess.py``):
spline derivatives of the state channels (``get_data_derivative:105-131``),
polyphase resampling (``resample_data:133-172``), standardization
(``standardize_data:235-266``), and the input/label column convention from
``config.yml``::

    inputs  = [roll, u_x, u_y, yaw_mder, steering, throttle]
    labels  = d/dt [roll, u_x, u_y, yaw_mder]

Everything here is numpy and scipy, as in the JAX package, so that both
packages draw the same batches from the same seed; CSVs are read with
numpy (the GPU machine has no pandas).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

STATE_COLS = ("roll", "u_x", "u_y", "yaw_mder")
CTRL_COLS = ("steering", "throttle")


def spline_derivative(t: np.ndarray, y: np.ndarray, degree: int = 3
                      ) -> np.ndarray:
    """d y/dt via an interpolating spline (preprocess.py:105-131, s=0)."""
    from scipy import interpolate

    spl = interpolate.UnivariateSpline(t, y, k=degree, s=0)
    return spl.derivative(n=1)(t)


def resample(y: np.ndarray, up: int, down: int) -> np.ndarray:
    """Polyphase resampling (preprocess.py:133-172)."""
    from scipy import signal

    return signal.resample_poly(y, up, down)


def standardize(data: np.ndarray, mean: Optional[np.ndarray] = None,
                std: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Column-wise standardization (preprocess.py:235-266); returns
    (standardized, mean, std) so the transform is invertible at inference."""
    if mean is None:
        mean = data.mean(axis=0)
    if std is None:
        std = data.std(axis=0)
        std = np.where(std == 0, 1.0, std)
    return (data - mean) / std, mean, std


def preprocess_trajectory(t: np.ndarray, states: np.ndarray,
                          controls: np.ndarray, spline_degree: int = 3
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Build (inputs (N, 6), labels (N, 4)) from a logged trajectory.

    ``states``: (N, 7) full state rows [x, y, yaw, roll, u_x, u_y,
    yaw_mder]; labels are spline derivatives of the 4 dynamics states.
    """
    dyn = states[:, 3:7]                       # roll, u_x, u_y, yaw_mder
    labels = np.stack([spline_derivative(t, dyn[:, i], spline_degree)
                       for i in range(4)], axis=1)
    inputs = np.concatenate([dyn, controls], axis=1)
    return inputs.astype(np.float32), labels.astype(np.float32)


def train_val_split(n: int, val_frac: float = 0.2, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled 80/20 split (trainer.py uses sklearn train_test_split)."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    n_val = int(n * val_frac)
    return idx[n_val:], idx[:n_val]


def read_csv_columns(path: str) -> dict:
    """A CSV with a header row as {column: array}, in the header's order:
    int64 where every value of a column is an integer, float64 where every
    value is a number (an empty field is NaN), else the strings."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    cols = {}
    for j, name in enumerate(header):
        vals = [r[j] if j < len(r) else "" for r in body]
        for dtype in (np.int64, np.float64):
            try:
                cols[name] = np.array(
                    [dtype(v) if v != "" else np.nan for v in vals],
                    dtype=dtype)
                break
            except (ValueError, OverflowError):
                continue
        else:
            cols[name] = np.array(vals, dtype=object)
    return cols


@dataclasses.dataclass
class DynamicsDataset:
    """In-memory dataset with shuffled mini-batch iteration (the reference's
    ``VehicleDynamicsDataset`` + DataLoader, ``torch_dataset_classes.py``)."""

    inputs: np.ndarray      # (N, 6)
    labels: np.ndarray      # (N, 4)

    def __post_init__(self):
        assert len(self.inputs) == len(self.labels)

    def __len__(self) -> int:
        return len(self.inputs)

    @classmethod
    def from_csv(cls, path: str,
                 input_cols: Sequence[str] = STATE_COLS + CTRL_COLS,
                 label_cols: Sequence[str] = tuple(
                     c + "_der" for c in STATE_COLS)) -> "DynamicsDataset":
        cols = read_csv_columns(path)
        return cls(np.stack([cols[c] for c in input_cols], 1).astype(
                       np.float32),
                   np.stack([cols[c] for c in label_cols], 1).astype(
                       np.float32))

    def split(self, val_frac: float = 0.2, seed: int = 0
              ) -> Tuple["DynamicsDataset", "DynamicsDataset"]:
        tr, va = train_val_split(len(self), val_frac, seed)
        return (DynamicsDataset(self.inputs[tr], self.labels[tr]),
                DynamicsDataset(self.inputs[va], self.labels[va]))

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = True
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        # drop_last=True like the reference DataLoader (trainer.py)
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            b = idx[i:i + batch_size]
            yield self.inputs[b], self.labels[b]
