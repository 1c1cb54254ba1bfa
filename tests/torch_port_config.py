"""The port's own configuration objects, built from JAX-package ones with
the same fields, for tests that drive both packages with one configuration."""

import dataclasses

from debias_vision_lang_torch.core import config as tconfig


def port_config(obj):
    """A JAX-package config dataclass -> the port's class of the same name,
    field by field (nested configs too)."""
    cls = getattr(tconfig, type(obj).__name__)
    fields = {}
    for f in dataclasses.fields(obj):
        if f.init:
            v = getattr(obj, f.name)
            fields[f.name] = port_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**fields)
