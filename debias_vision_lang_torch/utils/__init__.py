"""Observability helpers of the port."""

from .observability import (
    MetricsLogger,
    enable_debug_nans,
    profile_trace,
    step_timer,
)
