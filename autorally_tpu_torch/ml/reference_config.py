"""Reference ML-pipeline migration: ``config.yml`` + per-topic CSVs in
(port of ``autorally_tpu/ml/reference_config.py``).

A reference user's recorded data exists as rosbags; their own
``process_bag.py`` already converts those to per-topic CSVs (one file
per topic, ``extract_bag_to_csv``, ``process_bag.py:82-160``) named by
the ``filename:`` key of their ``config.yml`` ``topics:`` spec.  This
module takes it from there with zero ROS: parse the user's actual
``config.yml`` (``trainer.py:244-252`` load), read their per-topic CSVs
(with numpy: the GPU machine has no pandas), and run the per-topic
preprocessing pipeline (``ml/ingest.py``'s ``TopicData``) into the merged
training table the trainer consumes.  Parsing ``config.yml`` needs
PyYAML, which the GPU machine lacks: :func:`load_reference_config` raises
an ``ImportError`` that names it there.

Migration in three lines::

    cfg = load_reference_config("config.yml")
    table = ingest_reference_csvs("./csv_dir", cfg["topics"])
    params = train(table, layers=cfg["nn_layers"], ...)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from autorally_tpu_torch.ml.dataset import read_csv_columns
from autorally_tpu_torch.ml.ingest import (Table, order_by_stamp,
                                           run_topic_pipeline)


def load_reference_config(path: str) -> dict:
    """Parse the reference pipeline's ``config.yml`` (the exact file a
    reference user already has) into a plain dict with the keys the
    trainer consumes: ``state_cols``, ``ctrl_cols``, ``feature_cols``,
    ``label_cols``, ``nn_layers``, ``topics``, ``loss_weights``,
    ``epochs``, ``batch_size``, ``lr``, ``weight_decay``,
    ``train_data_fraction``, ``time_horizon``, ``standardize_data``,
    ``total_data``.
    """
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "reading a YAML config needs PyYAML, which is not installed "
            "(the trainer also reads a JSON config without it)") from e
    with open(path) as f:
        raw = yaml.safe_load(f)
    keys = ("state_cols", "ctrl_cols", "feature_cols", "label_cols",
            "nn_layers", "topics", "loss_weights", "epochs",
            "batch_size", "lr", "weight_decay", "train_data_fraction",
            "time_horizon", "standardize_data", "total_data", "run_name")
    out = {k: raw.get(k) for k in keys}
    missing = [k for k in ("feature_cols", "label_cols", "nn_layers",
                           "topics") if out.get(k) is None]
    if missing:
        raise ValueError(f"config.yml missing required keys: {missing}")
    return out


def read_csv_topics(csv_dir: str, topics: List[dict]) -> Dict[str, Table]:
    """Load per-topic CSVs (``process_bag.py`` output) from ``csv_dir``,
    keyed by topic name; rows re-ordered by header stamp like
    ``reorder_bag`` (``process_bag.py:41-79``)."""
    frames = {}
    for spec in topics:
        fname = spec.get("filename")
        if not fname:
            raise ValueError(
                f"topic '{spec.get('name')}' has no filename: key")
        fpath = os.path.join(csv_dir, fname)
        if not os.path.exists(fpath):
            raise FileNotFoundError(
                f"topic CSV {fpath} not found (run the reference "
                "process_bag.py on the bag first)")
        frames[spec["name"]] = order_by_stamp(Table(read_csv_columns(fpath)))
    return frames


def ingest_reference_csvs(csv_dir: str, topics: List[dict],
                          total_data: Optional[float] = None) -> Table:
    """Per-topic CSVs -> merged training table via the shared pipeline
    (quat->euler, spline derivatives, polyphase resample, truncation,
    common-window clip, column-wise merge — ``trainer.py:19-117``)."""
    frames = read_csv_topics(csv_dir, topics)
    return run_topic_pipeline(frames, topics, total_data)
