"""Model loader + ``ClipLike`` protocol (``debias_vision_lang_tpu/models/
loader.py``), for the OpenAI CLIP (ViT and ModifiedResNet), SLIP ViT and
Frozen-in-Time architectures.

Weight resolution, in the JAX package's order:
  1. an explicit ``weights=`` path, honored whatever ``pretrained`` says;
  2. ``$DEBIAS_VLT_WEIGHTS_DIR/<alias>.{npz,pt,bin,safetensors}``;
  3. for OpenAI CLIP names, a HuggingFace ``CLIPModel`` already in the local
     cache (``from_pretrained(..., local_files_only=True)``);
  4. ``pretrained=False`` -> random init from ``seed``; an unresolved
     ``pretrained=True`` warns and falls back to random init.
A checkpoint's key naming picks its converter (``_dispatch_state_dict``):
HuggingFace, facebookresearch/SLIP, m-bain/frozen-in-time or OpenAI CLIP (a
ViT or a ResNet, as OpenAI ships RN50 in a TorchScript archive).  A
Frozen-in-Time checkpoint carries no CLIP text tower: it is drawn at random
from ``seed``, with the JAX loader's warning.  A Frozen-in-Time model is a
``frozen_in_time.FrozenInTime``: "divided" when a loaded checkpoint's
temporal output projection is nonzero (trained), else "joint"; the choice
rides in ``cfg.vision.video_attention`` too.  Nothing here touches
the network: the JAX loader's networked retry of the HuggingFace lookup is
not ported, so weights are put in place beforehand.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import (Any, Callable, Dict, Mapping, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from ..core.config import CLIPConfig
from ..core.registry import VALID_MODELS, alias_name, resolve_arch
from ..text import load_bpe_tokenizer
from ..utils.device import resolve_device
from ..vision.preprocess import build_preprocess
from . import convert
from .clip import CLIP, TOWER_KINDS, init_clip_params, unknown_tower

_HF_NAMES = {
    "ViT-B/16": "openai/clip-vit-base-patch16",
    "ViT-B/32": "openai/clip-vit-base-patch32",
    "ViT-L/14": "openai/clip-vit-large-patch14",
}


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


def tower_kind(params: Mapping[str, Any]) -> str:
    """The image tower's kind of a converted ``CLIP`` state dict."""
    if any(k.startswith("visual.layer1.") for k in params):
        return "resnet"
    if any(k.startswith(("visual.temporal_embedding", "visual.temporal_attn."))
           for k in params):
        return "video_vit"
    return "vit" if "visual.ln_pre.scale" in params else "slip_vit"


def _dispatch_state_dict(obj: Mapping[str, Any], cfg: Optional[CLIPConfig] = None
                         ) -> Dict[str, torch.Tensor]:
    """Route a flat state dict to its converter by key naming: HuggingFace
    ``CLIPModel`` (``text_model.*``), facebookresearch/SLIP
    (``visual.blocks.*``), m-bain/frozen-in-time (``video_model.*``), else
    OpenAI CLIP.  The converted tree's contents give its kind:
    ``visual.layer1.*`` a ResNet, ``visual.temporal_*`` a video tower,
    ``visual.ln_pre.*`` an OpenAI ViT, any other a SLIP ViT (a conv bias and
    no pre-LN).  With ``cfg``, it must be of the architecture's kind, save
    that an OpenAI image ViT runs under a Frozen-in-Time arch, as in the
    JAX package (``convert.video_from_image_vit``)."""
    if "state_dict" in obj and not hasattr(obj["state_dict"], "shape"):
        obj = obj["state_dict"]
    keys = [k[7:] if k.startswith("module.") else k for k in obj]
    if any(k.startswith("video_model.") for k in keys):
        params = convert.from_fit_state_dict(obj)
    elif any(k.startswith("visual.blocks.") for k in keys):
        params = convert.from_slip_state_dict(obj)
    elif any(k.startswith("text_model.") for k in keys):
        params = convert.from_hf_state_dict(obj)
    else:
        params = convert.params_from_openai_state_dict(
            convert.strip_prefix(dict(obj)))
    kind = tower_kind(params)
    if cfg is not None and cfg.vision.kind == "video_vit" and kind == "vit":
        # the JAX loader runs an OpenAI image ViT's tree under a FiT arch
        params, kind = convert.video_from_image_vit(params), "video_vit"
    if cfg is not None and cfg.vision.kind != kind:
        raise ValueError(f"the checkpoint holds a {kind!r} image tower, the "
                         f"architecture {cfg.name!r} a {cfg.vision.kind!r} one")
    return params


def _load_weights_file(path: str, cfg: Optional[CLIPConfig] = None
                       ) -> Dict[str, torch.Tensor]:
    return _dispatch_state_dict(_read_state_dict(path), cfg)


def _resolve_pretrained(model_name: str, cfg: Optional[CLIPConfig] = None
                        ) -> Optional[Dict[str, torch.Tensor]]:
    """The weights directory (every family, keyed by alias), then, for the
    OpenAI CLIP archs, a HuggingFace model already in the local cache; any
    failure there gives None.  No download is tried."""
    wdir = os.environ.get("DEBIAS_VLT_WEIGHTS_DIR")
    if wdir:
        alias = alias_name(model_name)
        for ext in (".npz", ".pt", ".bin", ".safetensors"):
            cand = os.path.join(wdir, alias + ext)
            if os.path.exists(cand):
                return _load_weights_file(cand, cfg)
    arch = (model_name.split("/", 2)[-1]
            if model_name.startswith("openai/CLIP/") else None)
    if arch in _HF_NAMES:
        try:
            from transformers import CLIPModel  # absent on most machines

            hf = CLIPModel.from_pretrained(_HF_NAMES[arch], local_files_only=True)
            return convert.from_hf_model(hf)
        except Exception:
            return None
    return None


def _temporal_attn_trained(params: Mapping[str, Any]) -> bool:
    """True iff the video tower's temporal-attention OUTPUT projection
    (``wo`` or ``bo``) is nonzero, i.e. the divided formulation was trained:
    upstream FiT zero-inits ``timeattn.proj``, and the joint formulation
    never reads the subtree, so zero means no temporal signal."""
    return any(bool(torch.as_tensor(params[k]).ne(0).any())
               for k in ("visual.temporal_attn.attn.wo", "visual.temporal_attn.attn.bo")
               if k in params)


def model_loader(model_name: str, device="cuda", jit: bool = False,
                 pretrained: bool = True, weights: Optional[str] = None,
                 seed: int = 0) -> Tuple[CLIP, Callable, Optional[Callable], str]:
    """Returns (CLIP model on ``device``, image preprocess, tokenizer or
    None, alias); a ``FrozenInTime`` for the m-bain/frozen-in-time names.
    The model goes to the card unless ``device="cpu"``; with no card the
    default raises."""
    del jit
    device = resolve_device(device)
    if model_name not in VALID_MODELS:
        raise NotImplementedError(
            f"{model_name} not found, should be one of.. {VALID_MODELS}")
    cfg = resolve_arch(model_name)
    if cfg.vision.kind not in TOWER_KINDS:
        raise unknown_tower(cfg.vision.kind)
    alias = alias_name(model_name)
    params = None
    if weights is not None:
        params = _load_weights_file(weights, cfg)
    elif pretrained:
        params = _resolve_pretrained(model_name, cfg)
        if params is None:
            warnings.warn(
                f"pretrained weights for {model_name} could not be resolved "
                f"(no weights= file, $DEBIAS_VLT_WEIGHTS_DIR entry or local "
                f"HuggingFace cache) -- "
                f"falling back to RANDOM initialization. Pass "
                f"pretrained=False to silence, or weights=<path>.",
                stacklevel=2)
    loaded = params is not None
    if params is None:
        params = init_clip_params(cfg, torch.Generator().manual_seed(seed))
    elif not any(k.startswith("text.") for k in params):
        warnings.warn(
            f"{model_name}: checkpoint provided no text tower (upstream "
            "Frozen-in-Time uses DistilBERT; this framework keeps the CLIP "
            "text transformer) -- text weights are RANDOM-initialized.",
            stacklevel=2)
        drawn = init_clip_params(cfg, torch.Generator().manual_seed(seed))
        params = {**params, **{k: v for k, v in drawn.items() if k.startswith("text.")}}
    if cfg.vision.kind == "video_vit":
        from .frozen_in_time import FrozenInTime

        # a loaded checkpoint whose temporal output projection was trained
        # runs upstream's divided formulation; a fresh init, or a tree whose
        # temporal path is still the zero identity, the joint one
        attention = "divided" if loaded and _temporal_attn_trained(params) else "joint"
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, video_attention=attention))
        model = FrozenInTime(cfg, attention)
    else:
        model = CLIP(cfg)
    model.load_state_dict(params)
    model = model.to(device)
    preprocess = build_preprocess(cfg.vision.image_size, mean=cfg.vision.image_mean,
                                  std=cfg.vision.image_std)
    tokenizer = load_bpe_tokenizer(cfg.text.context_length)
    return model, preprocess, tokenizer, alias
