"""Model loader + ``ClipLike`` protocol (``debias_vision_lang_tpu/models/
loader.py``), for the OpenAI ViT architectures.

Weight resolution, in the JAX package's order:
  1. an explicit ``weights=`` path, honored whatever ``pretrained`` says;
  2. ``$DEBIAS_VLT_WEIGHTS_DIR/<alias>.{npz,pt,bin,safetensors}``;
  3. ``pretrained=False`` -> random init from ``seed``; an unresolved
     ``pretrained=True`` warns and falls back to random init.
Checkpoints in OpenAI CLIP naming convert here; HuggingFace-named
checkpoints and the hub lookup wait (ROADMAP.md queue 1 item 6).  Nothing
here touches the network.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Callable, Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from ..core.registry import VALID_MODELS, alias_name, resolve_arch
from ..text import load_bpe_tokenizer
from ..utils.device import resolve_device
from ..vision.preprocess import build_preprocess
from .clip import CLIP, ROADMAP_OTHER_TOWERS, init_clip_params
from .convert import params_from_openai_state_dict


@runtime_checkable
class ClipLike(Protocol):
    logit_scale: Any

    def encode_image(self, images) -> Any: ...

    def encode_text(self, tokenized_texts) -> Any: ...


def _read_state_dict(path: str) -> Dict[str, Any]:
    if path.endswith(".npz"):
        return dict(np.load(path))
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # a TorchScript archive, as OpenAI ships CLIP
        obj = torch.jit.load(path, map_location="cpu").state_dict()
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "state_dict" in obj and not hasattr(obj["state_dict"], "shape"):
        obj = obj["state_dict"]
    return {k[7:] if k.startswith("module.") else k: v for k, v in obj.items()}


def _load_weights_file(path: str) -> Dict[str, torch.Tensor]:
    sd = _read_state_dict(path)
    if any(k.startswith("text_model.") for k in sd):
        raise NotImplementedError(
            f"{path}: HuggingFace-named checkpoints do not convert yet; "
            "ROADMAP.md queue 1 item 6")
    return params_from_openai_state_dict(sd)


def _resolve_pretrained(model_name: str) -> Optional[Dict[str, torch.Tensor]]:
    wdir = os.environ.get("DEBIAS_VLT_WEIGHTS_DIR")
    if wdir:
        alias = alias_name(model_name)
        for ext in (".npz", ".pt", ".bin", ".safetensors"):
            cand = os.path.join(wdir, alias + ext)
            if os.path.exists(cand):
                return _load_weights_file(cand)
    return None


def model_loader(model_name: str, device="cuda", jit: bool = False,
                 pretrained: bool = True, weights: Optional[str] = None,
                 seed: int = 0) -> Tuple[CLIP, Callable, Optional[Callable], str]:
    """Returns (CLIP model on ``device``, image preprocess, tokenizer or
    None, alias).  The model goes to the card unless ``device="cpu"``; with
    no card the default raises."""
    del jit
    device = resolve_device(device)
    if model_name not in VALID_MODELS:
        raise NotImplementedError(
            f"{model_name} not found, should be one of.. {VALID_MODELS}")
    cfg = resolve_arch(model_name)
    if cfg.vision.kind != "vit":
        raise NotImplementedError(f"{model_name} ({cfg.vision.kind} tower): "
                                  f"{ROADMAP_OTHER_TOWERS}")
    alias = alias_name(model_name)
    params = None
    if weights is not None:
        params = _load_weights_file(weights)
    elif pretrained:
        params = _resolve_pretrained(model_name)
        if params is None:
            warnings.warn(
                f"pretrained weights for {model_name} could not be resolved "
                f"(no weights= file or $DEBIAS_VLT_WEIGHTS_DIR entry) -- "
                f"falling back to RANDOM initialization. Pass "
                f"pretrained=False to silence, or weights=<path>.",
                stacklevel=2)
    if params is None:
        params = init_clip_params(cfg, torch.Generator().manual_seed(seed))
    model = CLIP(cfg)
    model.load_state_dict(params)
    model = model.to(device)
    preprocess = build_preprocess(cfg.vision.image_size, mean=cfg.vision.image_mean,
                                  std=cfg.vision.image_std)
    tokenizer = load_bpe_tokenizer(cfg.text.context_length)
    return model, preprocess, tokenizer, alias
