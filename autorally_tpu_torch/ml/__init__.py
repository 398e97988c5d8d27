"""Offline ML pipeline: dynamics-model training in PyTorch (port of
``autorally_tpu/ml``).

Re-design of the reference's pipeline (``scripts/ml_pipeline/``): the
trained params dict drops directly into the MPPI solver, and the exported
``.npz`` (the reference interchange, ``utils.py:49-90``) loads at its own
layer spec with ``NeuralNetDynamics.from_npz``, which kernels 1 and 2 run
on the card.  Training runs on the card unless the caller asks for the
CPU; ingestion is numpy and scipy alone.
"""

from autorally_tpu_torch.ml.dataset import (DynamicsDataset,
                                            preprocess_trajectory,
                                            standardize, train_val_split)
from autorally_tpu_torch.ml.train import (TrainConfig, fold_standardization,
                                          train_dynamics)
from autorally_tpu_torch.ml.evaluate import (instantaneous_errors,
                                             multistep_errors)
from autorally_tpu_torch.ml.ingest import (SIM_NODE_TOPICS, TopicData,
                                           ingest_log, read_jsonl_topics)

__all__ = [
    "DynamicsDataset", "preprocess_trajectory", "standardize",
    "train_val_split", "TrainConfig", "train_dynamics",
    "fold_standardization", "instantaneous_errors", "multistep_errors",
    "SIM_NODE_TOPICS", "TopicData", "ingest_log", "read_jsonl_topics",
]
