"""Checkpoints of the controllers' states and the persistent build cache
(port of ``autorally_tpu/io``)."""
