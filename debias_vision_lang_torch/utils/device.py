"""Where the port's entry points run: on the card unless asked for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    (the entry points never fall back to the CPU: pass ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; the "
            f"port's entry points run on the card unless given device='cpu'")
    return dev
