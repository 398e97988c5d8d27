"""Evaluation / preprocessing plots (port of ``autorally_tpu/ml/plots.py``;
the ``ml_pipeline/utils.py`` plotting role, ``utils.py:120-339``):
state-vs-time + trajectory overviews of the preprocessed data, training
curves, and the multi-step prediction-error figure (mean curve + box plots
at regular horizons + terminal-error histograms).  All figures save to
files (Agg backend, no display).  They need matplotlib, which the GPU
machine lacks: there they raise an ``ImportError`` that names it, and the
trainer's ``make_plots`` is for machines that have it."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the ML plots need matplotlib, which is not "
                          "installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def state_variable_plots(df, cols: Sequence[str], dir_path: str,
                         label: str = "preprocessed",
                         x_col: str = "x_pos", y_col: str = "y_pos"
                         ) -> List[str]:
    """Per-column state-vs-time pages plus an x/y trajectory plot
    (``state_variable_plots`` / ``state_der_plots`` role); ``df`` the
    merged table (``ml/ingest.py``'s ``Table``)."""
    plt = _plt()
    os.makedirs(dir_path, exist_ok=True)
    out = []
    t = np.asarray(df["time"])

    cols = [c for c in cols if c in df.columns]
    n = len(cols)
    if n:
        fig, axes = plt.subplots((n + 2) // 3, 3,
                                 figsize=(12, 2.2 * ((n + 2) // 3)),
                                 squeeze=False)
        for ax, c in zip(axes.flat, cols):
            ax.plot(t, np.asarray(df[c]), lw=0.8)
            ax.set_title(c, fontsize=9)
            ax.tick_params(labelsize=7)
        for ax in axes.flat[n:]:
            ax.axis("off")
        fig.suptitle(f"state variables ({label})")
        fig.tight_layout()
        p = os.path.join(dir_path, "state_variables.png")
        fig.savefig(p, dpi=110)
        plt.close(fig)
        out.append(p)

    if x_col in df.columns and y_col in df.columns:
        fig = plt.figure(figsize=(6, 6))
        plt.plot(df[x_col], df[y_col], lw=0.8)
        plt.axis("equal")
        plt.xlabel("x (m)")
        plt.ylabel("y (m)")
        plt.title(f"trajectory ({label})")
        p = os.path.join(dir_path, "trajectory.png")
        fig.savefig(p, dpi=110)
        plt.close(fig)
        out.append(p)
    return out


def training_curve_plot(history: Dict[str, list], dir_path: str) -> str:
    """Train/val loss curves (the reference prints these per epoch but
    never plots them)."""
    plt = _plt()
    os.makedirs(dir_path, exist_ok=True)
    fig = plt.figure(figsize=(7, 4))
    plt.plot(history["train"], label="train")
    plt.plot(history["val"], label="val")
    plt.yscale("log")
    plt.xlabel("epoch")
    plt.ylabel("weighted smooth-L1 loss")
    plt.legend()
    plt.title("dynamics-model training")
    p = os.path.join(dir_path, "training_curve.png")
    fig.savefig(p, dpi=110)
    plt.close(fig)
    return p


def multi_step_error_plots(error_data, time_data, dir_path: str,
                           x_idx: int = 0, y_idx: int = 1,
                           yaw_idx: int = 2,
                           time_horizon: Optional[float] = None,
                           num_box_plots: int = 5,
                           track_width: float = 3.0) -> List[str]:
    """Multi-step prediction error figure (``utils.py:240-339``):
    mean absolute error vs time for x/y/yaw with box plots at
    ``num_box_plots`` evenly spaced horizons, plus a terminal position-
    error histogram binned against the track width.

    ``error_data``: (batches, timesteps, states) absolute errors;
    ``time_data``: (timesteps,) seconds.
    """
    plt = _plt()
    os.makedirs(dir_path, exist_ok=True)
    error_data = np.asarray(error_data)
    time_data = np.asarray(time_data)
    mean_errors = error_data.mean(axis=0)
    horizon = float(time_horizon if time_horizon is not None
                    else time_data[-1])
    errorevery = max(1, (len(time_data) - 1) // num_box_plots)

    fig = plt.figure(figsize=(11, 4))
    out = []
    for plot_idx, (idx, name, unit) in enumerate(
            zip([x_idx, y_idx, yaw_idx], ["x_pos", "y_pos", "yaw"],
                ["m", "m", "rad"]), start=1):
        ax = fig.add_subplot(1, 3, plot_idx)
        ax.plot(time_data, mean_errors[:, idx], label=name)
        indices = np.arange(errorevery, len(time_data), errorevery)
        ax.boxplot(error_data[:, indices, idx],
                   positions=time_data[indices], showmeans=True,
                   meanline=True,
                   widths=0.04 * (time_data[-1] - time_data[0] + 1e-9))
        ax.axvline(x=horizon, ls="--", lw=1, color="k",
                   label="time horizon")
        ax.set_xlabel("time (s)")
        ax.set_ylabel(f"mean absolute error ({unit})")
        ax.set_xticks(np.linspace(time_data[0], time_data[-1], 5))
        ax.set_xticklabels([f"{v:.1f}" for v in
                            np.linspace(time_data[0], time_data[-1], 5)])
        ax.legend(loc="upper left", fontsize=7)
    fig.suptitle("Multi-step prediction error on vehicle dynamics")
    fig.tight_layout()
    p = os.path.join(dir_path, "multi_step_error_plot.png")
    fig.savefig(p, dpi=110)
    plt.close(fig)
    out.append(p)

    # terminal position-error histogram (utils.py:309-339)
    fig = plt.figure(figsize=(8, 4))
    for j, (name, color) in enumerate(zip(["x_pos", "y_pos"],
                                          ["tab:blue", "tab:red"])):
        err = error_data[:, -1, [x_idx, y_idx][j]]
        ax = fig.add_subplot(1, 2, j + 1)
        upper = max(track_width, float(np.ceil(err.max()))) + 0.1
        bins = np.concatenate([np.arange(0, track_width, 0.5),
                               np.arange(track_width, upper, track_width)])
        ax.hist(err, bins=bins, density=True, label=name, color=color,
                edgecolor="black", alpha=0.6)
        ax.set_xlabel("error (m)")
        ax.set_ylabel("density")
        ax.legend()
    fig.suptitle(f"Terminal errors at t={time_data[-1]:.2f} s "
                 f"(n={error_data.shape[0]}, track {track_width:.1f} m)")
    fig.tight_layout()
    p = os.path.join(dir_path, "terminal_error_hist.png")
    fig.savefig(p, dpi=110)
    plt.close(fig)
    out.append(p)
    return out
