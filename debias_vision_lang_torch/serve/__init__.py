"""Batched inference serving (the port's ``debias_vision_lang_tpu/serve``).

Micro-batched device launches at power-of-two bucket shapes, through the
hand-written kernels on the card, the native ingest runtime on the decode
path where it is built, and a stdlib HTTP front end.
"""

from .batcher import MicroBatcher
from .engine import InferenceEngine, decode_image_bytes
from .server import ServeApp, make_server, serve_forever

__all__ = [
    "MicroBatcher",
    "InferenceEngine",
    "decode_image_bytes",
    "ServeApp",
    "make_server",
    "serve_forever",
]
