from .hub import _MODELS, available_models, load
