"""Observability: structured metrics logging, a profiler trace, a step
timer and a NaN-detection toggle.

Counterpart of ``debias_vision_lang_tpu/utils/observability.py``: the JSONL
``MetricsLogger``, ``profile_trace`` on ``torch.profiler`` in place of
``jax.profiler``, ``step_timer``, and ``enable_debug_nans`` on autograd's
anomaly mode in place of ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` trace around a region (CPU activity, and CUDA
    activity where a card is visible), written under ``log_dir`` as a
    ``*.pt.trace.json`` file (TensorBoard's PyTorch profiler plugin, or
    chrome://tracing).  Yields the profiler, or None when not ``enabled``,
    which traces nothing."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def step_timer(logger: Optional[MetricsLogger] = None, name: str = "step_time_s",
               step: Optional[int] = None):
    """Wall-clock timer: yields a dict whose ``"elapsed"`` is set to the
    region's seconds on exit, and logs it as ``name`` when given a logger.
    Kernels run asynchronously: to time device work the caller synchronizes
    (``torch.cuda.synchronize()``) before the region ends."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        box["elapsed"] = time.perf_counter() - t0
        if logger is not None:
            logger.log({name: box["elapsed"]}, step=step)


def enable_debug_nans(on: bool = True) -> None:
    """NaN detection: autograd's anomaly mode with its NaN check
    (``torch.autograd.set_detect_anomaly(on, check_nan=True)``).  Unlike
    ``jax_debug_nans``, which raises at the forward op that makes a NaN,
    this raises in the backward pass, at the first gradient function that
    returns a NaN, and names the forward op that recorded it; a NaN made in
    a forward no backward runs through (inference) is not caught."""
    import torch

    torch.autograd.set_detect_anomaly(on, check_nan=True)
