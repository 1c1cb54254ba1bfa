"""Observability: structured metrics logging, a profiler trace, a step
timer and a NaN-detection toggle.

Counterpart of ``debias_vision_lang_tpu/utils/observability.py``: the JSONL
``MetricsLogger``, ``profile_trace`` on ``torch.profiler`` in place of
``jax.profiler``, ``step_timer``, and ``enable_debug_nans``: a torch function
mode and the kernel entries' output checks in place of ``jax_debug_nans``,
with autograd's anomaly mode for the backward pass.
"""

from __future__ import annotations

import contextlib
import functools
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


# enable_debug_nans's state: the function mode it entered (None when off)
_DEBUG_NANS = {"mode": None}


def debug_nans_on() -> bool:
    return _DEBUG_NANS["mode"] is not None


def _nan_in(t) -> bool:
    import torch

    return (isinstance(t, torch.Tensor) and t.dtype.is_floating_point
            and t.device.type != "meta" and bool(torch.isnan(t).any()))


def check_nans(what: str, *tensors) -> None:
    """Under ``enable_debug_nans``, raise ``FloatingPointError`` naming
    ``what`` if any of ``tensors`` holds a NaN; a kernel entry calls it on
    its output (a ctypes launch is no torch function, so the function mode
    does not see it).  Off, one dict lookup."""
    if _DEBUG_NANS["mode"] is not None and any(map(_nan_in, tensors)):
        raise FloatingPointError(f"NaN in the output of {what} (enable_debug_nans)")


_NAN_MODE_CLASS = []


def _nan_mode():
    """A new NaN function mode (one per thread that enters it: torch keeps
    the mode stack per thread)."""
    if not _NAN_MODE_CLASS:
        import torch
        from torch.overrides import TorchFunctionMode

        # factories of uninitialised memory may hold any bits
        skip = {torch.empty, torch.empty_like, torch.empty_strided, torch.Tensor.new_empty,
                torch.Tensor.new_empty_strided}

        class NanMode(TorchFunctionMode):
            """Every torch function's floating outputs checked for NaN, as
            ``jax_debug_nans`` checks every primitive's."""

            def __torch_function__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if func not in skip:
                    outs = out if isinstance(out, (tuple, list)) else (out,)
                    if any(map(_nan_in, outs)):
                        name = (getattr(func, "__qualname__", None)
                                or getattr(func, "__name__", func))
                        raise FloatingPointError(
                            f"NaN in the output of {name} (enable_debug_nans)")
                return out

        _NAN_MODE_CLASS.append(NanMode)
    return _NAN_MODE_CLASS[0]()


def _thread_checked() -> bool:
    """This thread runs under a NaN function mode already."""
    from torch.overrides import _get_current_function_mode_stack

    return bool(_NAN_MODE_CLASS) and any(isinstance(m, _NAN_MODE_CLASS[0])
                                         for m in _get_current_function_mode_stack())


def debug_nans_thread(fn):
    """``fn`` with the NaN function mode entered on the calling thread for
    the call while ``enable_debug_nans`` is on, if that thread has not
    entered it (``jax_debug_nans`` is global; torch's function modes are per
    thread).  The port wraps the functions its own threads run with it: the
    serving batcher's worker and finalizer (``serve/engine.py``'s dispatch
    and fetch).  Off: one dict lookup."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _DEBUG_NANS["mode"] is None or _thread_checked():
            return fn(*args, **kwargs)
        with _nan_mode():
            return fn(*args, **kwargs)

    return wrapped


def enable_debug_nans(on: bool = True) -> None:
    """NaN detection, as ``jax_debug_nans``: with ``on``, every torch
    function called on this thread has its floating outputs checked, and
    the CUDA kernel entries of ``ops/`` check theirs (``check_nans``), so a
    forward op that makes a NaN raises ``FloatingPointError`` there, with or
    without a backward (inference: ``measure_bias``, serving); autograd's
    anomaly mode (``torch.autograd.set_detect_anomaly(on, check_nan=True)``)
    names the forward op of a NaN made in the backward pass.  Off (the
    default) nothing is installed: the kernel entries' check is one dict
    lookup.  The function mode is entered on the calling thread here (torch
    keeps modes per thread), and on each thread the port starts as it runs
    its work (``debug_nans_thread``); the kernel entries' check holds on
    every thread."""
    import torch

    torch.autograd.set_detect_anomaly(on, check_nan=True)
    mode = _DEBUG_NANS["mode"]
    if on and mode is None:
        mode = _nan_mode()
        mode.__enter__()
        _DEBUG_NANS["mode"] = mode
    elif not on and mode is not None:
        mode.__exit__(None, None, None)
        _DEBUG_NANS["mode"] = None
