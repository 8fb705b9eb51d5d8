"""Tail a live in-situ run of the port over TCP and optionally steer it.

    PYTHONPATH=src python tools/torch_insitu_consumer.py --port 9100 \\
        --steer '{"task": "kv_snapshot", "every": 2}' --restore kv_pages

Point any producer transport at the printed address: a plan option
``"to": "tcp://127.0.0.1:9100"``, a ``CheckpointConfig.mirror``, or
``repro_torch.launch.serve --snapshot-to tcp://127.0.0.1:9100``
(``--port 0``, the default, picks a free port). Snapshot chain frames
build a local replica (``--restore`` prints its digest), checkpoint shards
land under ``--out-dir``, and analysis artifacts are decoded with the
shared registry. The wire format is the JAX package's, so either package
may produce. A thin CLI over ``repro_torch.launch.consume.main``; it
needs no JAX and no card.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.consume import main  # noqa: E402

if __name__ == "__main__":
    main()
