"""Checkpoints of the controllers' states (port of ``autorally_tpu/io``;
``compile_cache.py`` is listed in ROADMAP.md, Queue 1 item 8)."""
