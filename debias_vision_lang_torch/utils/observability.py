"""Structured metrics logging for the port.

Counterpart of ``debias_vision_lang_tpu/utils/observability.py``'s
``MetricsLogger`` (that module's profiling hooks are ``jax.profiler``'s; the
port's kernel timings come from ``torch.profiler`` / CUDA events in
``chip_smoke.py``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def _to_jsonable(v):
    if getattr(v, "shape", None) == () and hasattr(v, "item"):
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    raise TypeError(f"metric value of type {type(v).__name__} is not JSON-serializable")


class MetricsLogger:
    """Append-only JSONL metrics at ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._file = open(self.path, "a", buffering=1)

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        record = {"time": time.time(), **metrics}
        if step is not None:
            record["step"] = step
        self._file.write(json.dumps(record, default=_to_jsonable) + "\n")

    def close(self) -> None:
        self._file.close()
