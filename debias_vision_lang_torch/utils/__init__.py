"""Observability helpers of the port."""
