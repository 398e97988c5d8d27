"""Multi-topic log ingestion: drive logs -> merged training table (port of
``autorally_tpu/ml/ingest.py``).

The reference front end is rosbag-based: ``process_bag.py`` reorders a
bag by header timestamps and extracts per-topic CSVs
(``process_bag.py:43-160``), then ``preprocess.py``'s ``DataClass`` runs
a per-topic pipeline — load/rename, quaternion->euler, spline
derivatives, polyphase resampling to a common rate, truncation — and the
trainer clips topics to a common window, concatenates them column-wise
and optionally standardizes (``trainer.py:19-160``).

The "bag" is the JSONL multi-topic log written by the simulator node
(``tools/sim_node.py --log``, ``log_topics``) or any process emitting
``{"topic": ..., "secs": ..., "nsecs": ..., <fields>}`` rows.  The JAX
package keeps each topic in a pandas DataFrame; the GPU machine has no
pandas, so a topic here is a :class:`Table` of named numpy columns with a
row index, which keeps the DataFrames' column order, index alignment and
NaN rules that the pipeline relies on.  The per-topic steps, their
resampling and merge rules, scipy's ``Rotation`` and the column names are
the JAX module's.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np


def _column(values: list) -> np.ndarray:
    """A column from row values, as pandas types a list of records: int64
    if all are integers, float64 if all are numbers (None is NaN), else
    objects."""
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
           for v in values):
        return np.array(values, dtype=np.int64)
    if all(v is None or (isinstance(v, (int, float, np.number))
                         and not isinstance(v, bool)) for v in values):
        return np.array([np.nan if v is None else v for v in values],
                        dtype=np.float64)
    return np.array(values, dtype=object)


def _isna(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "O":
        return np.array([v is None or (isinstance(v, float) and math.isnan(v))
                         for v in col], dtype=bool)
    return np.zeros(len(col), dtype=bool)


class Table:
    """Named 1-D numpy columns of one length, in order, with row labels
    (``index``): the part of a pandas DataFrame that the pipeline uses."""

    def __init__(self, columns: Optional[Dict[str, np.ndarray]] = None,
                 index: Optional[np.ndarray] = None):
        self.cols = {k: np.asarray(v) for k, v in (columns or {}).items()}
        n = len(next(iter(self.cols.values()))) if self.cols else 0
        self.index = (np.arange(n) if index is None
                      else np.asarray(index, dtype=np.int64))

    @classmethod
    def from_records(cls, records: List[dict]) -> "Table":
        """A table from records; its columns in order of first appearance,
        a missing field NaN (``pd.DataFrame(records)``)."""
        names = list(dict.fromkeys(k for r in records for k in r))
        return cls({k: _column([r.get(k) for r in records]) for k in names})

    @property
    def columns(self) -> List[str]:
        return list(self.cols)

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, name: str) -> bool:
        return name in self.cols

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.cols[key]
        return Table({k: self.cols[k] for k in key}, self.index)

    def __setitem__(self, name: str, values) -> None:
        self.cols[name] = np.broadcast_to(np.asarray(values),
                                          (len(self),)).copy()

    def copy(self) -> "Table":
        return Table({k: v.copy() for k, v in self.cols.items()},
                     self.index.copy())

    def rows(self, which) -> "Table":
        """The rows ``which`` (a mask or positions), keeping their labels."""
        return Table({k: v[which] for k, v in self.cols.items()},
                     self.index[which])

    def rename(self, mapper: dict) -> "Table":
        return Table({mapper.get(k, k): v for k, v in self.cols.items()},
                     self.index)

    def drop(self, names: Sequence[str]) -> "Table":
        return Table({k: v for k, v in self.cols.items() if k not in names},
                     self.index)

    def reset_index(self) -> "Table":
        return Table(self.cols)

    def dropna(self) -> "Table":
        keep = np.ones(len(self), dtype=bool)
        for v in self.cols.values():
            keep &= ~_isna(v)
        return self.rows(keep)

    def to_numpy(self, names: Sequence[str], dtype=np.float32) -> np.ndarray:
        """The columns ``names`` as an (N, len(names)) array, column-major
        as a DataFrame's ``to_numpy``: numpy's sums over its rows (a
        standardization's mean) then take the same order."""
        return np.stack([self.cols[k].astype(dtype) for k in names]).T

    def to_csv(self, path: str) -> None:
        """Write the columns with a header row (no index), each float in
        its shortest round-trip form."""
        def fmt(v):
            return "" if v is None else (repr(float(v)) if isinstance(
                v, (float, np.floating)) else str(v))

        with open(path, "w") as f:
            f.write(",".join(self.cols) + "\n")
            for row in zip(*self.cols.values()):
                f.write(",".join(fmt(v) for v in row) + "\n")


def concat_columns(tables: List[Table]) -> Table:
    """The tables side by side, rows aligned on their labels (the union of
    labels in order of appearance; a label a table lacks is NaN there), as
    ``pd.concat(..., axis=1)``."""
    labels = list(dict.fromkeys(int(i) for t in tables for i in t.index))
    cols = {}
    for t in tables:
        where = {int(i): r for r, i in enumerate(t.index)}
        pos = np.array([where.get(i, -1) for i in labels], dtype=np.int64)
        for k, v in t.cols.items():
            if (pos >= 0).all():
                cols[k] = v[pos]
            else:
                out = np.full(len(labels), np.nan)
                out[pos >= 0] = v[pos[pos >= 0]]
                cols[k] = out
    return Table(cols, np.array(labels, dtype=np.int64))


def order_by_stamp(table: Table) -> Table:
    """Rows in order of ``secs + nsecs / 1e9`` (stable), index reset."""
    if "secs" not in table:
        return table
    key = table["secs"] + (table["nsecs"] if "nsecs" in table else 0) / 1e9
    return table.rows(np.argsort(key, kind="stable")).reset_index()


def read_jsonl_topics(path: str) -> Dict[str, Table]:
    """Split a JSONL log into per-topic tables, rows ordered by timestamp
    (the reorder_bag + extract_bag_to_csv roles,
    ``process_bag.py:43-160``)."""
    rows: Dict[str, list] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            topic = rec.pop("topic", None)
            if topic is None:
                continue
            rows.setdefault(topic, []).append(rec)
    return {topic: order_by_stamp(Table.from_records(rs))
            for topic, rs in rows.items()}


class TopicData:
    """Per-topic preprocessing pipeline (``preprocess.py`` DataClass)."""

    def __init__(self, df: Table, column_mapper: Optional[dict] = None):
        self.df = df.copy()
        self.column_mapper = column_mapper

    # -- load/format steps (DataClass.prep_data, preprocess.py:28-72) -------

    def format_time_col(self) -> "TopicData":
        """secs + nsecs/1e9 combined IN PLACE into ``secs``
        (preprocess.py:54-59) — the reference's col_mapper then renames
        ``secs`` to ``time``.  For specs whose mapper doesn't, ``time``
        is also set directly (the JSONL sim-node topics)."""
        if "secs" in self.df:
            self.df["secs"] = self.df["secs"] + (
                self.df["nsecs"] if "nsecs" in self.df else 0) / 1e9
            mapped = (self.column_mapper or {}).get("secs")
            if mapped != "time":
                self.df["time"] = self.df["secs"]
        return self

    def rename_cols(self) -> "TopicData":
        if self.column_mapper:
            self.df = self.df.rename(self.column_mapper)
        return self

    def extract_cols(self, cols: List[str]) -> "TopicData":
        self.df = self.df[list(cols)]
        return self

    def trim_sequence(self, end_point: float) -> "TopicData":
        """Keep rows with time <= end_point (preprocess.py:74-79)."""
        self.df = self.df.rows(self.df["time"] <= end_point)
        return self

    # -- math steps ----------------------------------------------------------

    def quaternion_to_euler(self, x_col: str, y_col: str, z_col: str,
                            w_col: str) -> "TopicData":
        """Quaternion -> roll/pitch/yaw columns, scipy 'xyz' convention
        exactly like the reference (preprocess.py:175-205)."""
        from scipy.spatial.transform import Rotation

        quats = self.df.to_numpy([x_col, y_col, z_col, w_col], float)
        eul = Rotation.from_quat(quats).as_euler("xyz", degrees=False)
        self.df["roll"] = eul[:, 0]
        self.df["pitch"] = eul[:, 1]
        self.df["yaw"] = eul[:, 2]
        return self

    def get_data_derivative(self, cols: List[str], degree: int = 3
                            ) -> "TopicData":
        """Interpolating-spline derivatives, ``<col>_der``
        (preprocess.py:105-131)."""
        from autorally_tpu_torch.ml.dataset import spline_derivative

        t = self.df["time"].astype(float)
        for c in cols:
            self.df[c + "_der"] = spline_derivative(
                t, self.df[c].astype(float), degree)
        return self

    def resample_data(self, end_point: float, up: int, down: int,
                      cols: List[str]) -> "TopicData":
        """Polyphase resample selected columns and rebuild the time axis
        on [0, end_point] (preprocess.py:133-172; the reference's
        time-starts-at-zero assumption is preserved by shifting)."""
        from scipy import signal

        new = {}
        t_new = None
        for c in cols:
            if c not in self.df:
                continue
            y = signal.resample_poly(self.df[c].astype(float), up, down)
            new[c] = y
            if t_new is None:
                t_new = np.linspace(0, end_point, len(y))
                new["time"] = t_new
        self.df = Table(new)
        return self

    def trunc(self, cols: List[str], maximum: float = 1.0,
              minimum: float = -1.0) -> "TopicData":
        """Clip columns into [minimum, maximum] (preprocess.py:81-103)."""
        for c in cols:
            self.df[c] = np.clip(self.df[c], minimum, maximum)
        return self


def clip_start_end_times(col: str, *dfs: Table) -> List[Table]:
    """Clip all tables to [ceil(max start), floor(min end)] on ``col``
    (preprocess.py:207-233)."""
    start = max(df[col][0] for df in dfs)
    end = min(df[col][-1] for df in dfs)
    lo, hi = np.ceil(start), np.floor(end)
    return [df.rows((df[col] >= lo) & (df[col] <= hi)) for df in dfs]


# Topic spec for sim-node logs, same shape as the reference config.yml
# ``topics:`` list (col_mapper / quaternion_to_euler / compute_derivatives
# / resample / trunc) so a reference user's config ports directly.
SIM_NODE_TOPICS = [
    {
        "name": "ground_truth/state",
        "col_mapper": {"x": "x_pos", "y": "y_pos"},
        "quaternion_to_euler": {"x": "qx", "y": "qy", "z": "qz", "w": "qw"},
        "compute_derivatives": {"cols": ["roll", "u_x", "u_y", "yaw_mder"],
                                "degree": 3},
        "resample": {"upsampling_factor": 1, "downsampling_factor": 1,
                     "cols": ["x_pos", "y_pos", "yaw", "roll", "roll_der",
                              "u_x", "u_x_der", "u_y", "u_y_der",
                              "yaw_mder", "yaw_mder_der"]},
        "trunc": {"cols": ["roll", "yaw"],
                  "max": np.pi, "min": -np.pi},
    },
    {
        "name": "chassisState",
        "col_mapper": {},
        "resample": {"upsampling_factor": None, "downsampling_factor": None,
                     "cols": ["steering", "throttle"]},
        "trunc": {"cols": ["steering", "throttle"], "max": 1.0, "min": -1.0},
    },
]


def ingest_log(path: str, topics: Optional[List[dict]] = None,
               total_data: Optional[float] = None) -> Table:
    """Run the full multi-topic pipeline on a JSONL log and return the
    merged training table (the trainer.py ``preprocess_data`` phase,
    trainer.py:19-117: per-topic DataClass steps, resample to the first
    topic's rate, column-wise concat)."""
    topics = SIM_NODE_TOPICS if topics is None else topics
    return run_topic_pipeline(read_jsonl_topics(path), topics, total_data)


def run_topic_pipeline(frames: Dict[str, Table], topics: List[dict],
                       total_data: Optional[float] = None) -> Table:
    """Per-topic tables -> merged training table (shared by the JSONL path
    above and the reference-CSV migration path,
    ``ml/reference_config.py``)."""
    dfs = []
    end_point = None
    sample_rate = None
    for spec in topics:
        name = spec["name"]
        if name not in frames:
            raise ValueError(f"topic '{name}' not present; "
                             f"found {sorted(frames)}")
        td = TopicData(frames[name], spec.get("col_mapper"))
        td.format_time_col().rename_cols()
        if total_data:
            td.trim_sequence(total_data + round(td.df["time"][0]))
        if "quaternion_to_euler" in spec:
            q = spec["quaternion_to_euler"]
            td.quaternion_to_euler(q["x"], q["y"], q["z"], q["w"])
        if "compute_derivatives" in spec:
            der = spec["compute_derivatives"]
            td.get_data_derivative(der["cols"], der["degree"])
        if end_point is None:
            end_point = int(round(td.df["time"][-1])
                            - round(td.df["time"][0]))
        rs = spec.get("resample", {})
        if rs.get("cols"):
            if not rs.get("upsampling_factor"):
                # match-the-first-topic convention: resample this topic to
                # the row count an earlier topic established
                if sample_rate is None:
                    raise ValueError(
                        f"topic '{name}': the first resampled topic must "
                        "set explicit upsampling_factor/downsampling_factor"
                        " — there is no earlier topic to match")
                up, down = sample_rate, len(td.df)
            else:
                up, down = rs["upsampling_factor"], rs["downsampling_factor"]
            td.resample_data(end_point, up, down, rs["cols"])
            sample_rate = len(td.df)
        if "trunc" in spec:
            tr = spec["trunc"]
            td.trunc(tr["cols"], maximum=tr["max"], minimum=tr["min"])
        dfs.append(td.df)

    # merge columns; keep one time axis (trainer.py:108-110 concat)
    final = concat_columns([dfs[0]] + [d.drop(["time"]) for d in dfs[1:]])
    return final.dropna().reset_index()
