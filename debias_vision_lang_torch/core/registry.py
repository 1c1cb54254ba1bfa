"""Model registry: names → architecture configs + aliases (the port's own
copy of ``debias_vision_lang_tpu/core/registry.py``, held to it by
tests/test_torch_standalone.py).

Mirrors the reference's ``VALID_CLIP_MODELS`` list and alias scheme
(reference: debias_clip/model/model.py:85-122) but backs each name with a
full architecture config so models build offline with random init (the
reference delegates the architecture to the external ``clip`` package).
The two families the reference advertises but stubs with
``NotImplementedError`` (m-bain/frozen-in-time, facebookresearch/SLIP —
reference: debias_clip/model/model.py:115-118) are first-class here.
"""

from __future__ import annotations

from typing import Dict, List

from .config import CLIPConfig, TextConfig, VisionConfig


def _vit(name, patch, width, layers, heads, embed, t_width, t_heads, t_layers,
         image=224, kind="vit", stats=None):
    vkw = {} if stats is None else {"image_mean": stats[0],
                                    "image_std": stats[1]}
    return CLIPConfig(
        name=name,
        vision=VisionConfig(kind=kind, image_size=image, patch_size=patch,
                            width=width, layers=layers, heads=heads,
                            embed_dim=embed, **vkw),
        text=TextConfig(width=t_width, heads=t_heads, layers=t_layers, embed_dim=embed),
    )


# SLIP and Frozen-in-Time trained with torchvision's ImageNet normalization
# (upstream facebookresearch/SLIP and m-bain/frozen-in-time transforms) —
# NOT OpenAI CLIP's stats
IMAGENET_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def _resnet(name, stages, stem_width, embed, image, t_width, t_heads):
    # Attention-pool head count follows OpenAI CLIP: stem_width * 32 / 64.
    return CLIPConfig(
        name=name,
        vision=VisionConfig(kind="resnet", image_size=image, patch_size=32,
                            width=stem_width, layers=stages,
                            heads=stem_width * 32 // 64, embed_dim=embed),
        text=TextConfig(width=t_width, heads=t_heads, layers=12, embed_dim=embed),
    )


# Architecture table for the 6 OpenAI CLIP archs the reference validates
# against (reference: debias_clip/model/model.py:85-92).
CLIP_ARCHS: Dict[str, CLIPConfig] = {
    "RN50": _resnet("RN50", (3, 4, 6, 3), 64, 1024, 224, 512, 8),
    "RN101": _resnet("RN101", (3, 4, 23, 3), 64, 512, 224, 512, 8),
    "RN50x4": _resnet("RN50x4", (4, 6, 10, 6), 80, 640, 288, 640, 10),
    "ViT-B/32": _vit("ViT-B/32", 32, 768, 12, 12, 512, 512, 8, 12),
    "ViT-B/16": _vit("ViT-B/16", 16, 768, 12, 12, 512, 512, 8, 12),
    "ViT-L/14": _vit("ViT-L/14", 14, 1024, 24, 16, 768, 768, 12, 12),
}

# SLIP uses a timm-style ViT (standard GELU, not QuickGELU) with CLIP's text
# tower; Frozen-in-Time is a multi-frame video ViT.  Registered as distinct
# kinds so model builders can branch.
SLIP_ARCHS: Dict[str, CLIPConfig] = {
    "ViT-B/16": _vit("SLIP-ViT-B/16", 16, 768, 12, 12, 512, 512, 8, 12,
                     kind="slip_vit", stats=IMAGENET_STATS),
    "ViT-L/16": _vit("SLIP-ViT-L/16", 16, 1024, 24, 16, 512, 512, 8, 12,
                     kind="slip_vit", stats=IMAGENET_STATS),
}

FIT_ARCHS: Dict[str, CLIPConfig] = {
    # Frozen-in-Time base: ViT-B/16 space-time encoder, 4 frames default.
    "base": _vit("FiT-ViT-B/16", 16, 768, 12, 12, 256, 512, 8, 12,
                 kind="video_vit", stats=IMAGENET_STATS),
}

VALID_CLIP_MODELS: List[str] = [f"openai/CLIP/{arch}" for arch in CLIP_ARCHS]
VALID_SLIP_MODELS: List[str] = [f"facebookresearch/SLIP/{arch}" for arch in SLIP_ARCHS]
VALID_FIT_MODELS: List[str] = [f"m-bain/frozen-in-time/{arch}" for arch in FIT_ARCHS]

VALID_MODELS: List[str] = VALID_CLIP_MODELS + VALID_SLIP_MODELS + VALID_FIT_MODELS


def resolve_arch(model_name: str) -> CLIPConfig:
    """Full model name (``openai/CLIP/ViT-B/16``) or bare arch → config."""
    if model_name in CLIP_ARCHS:
        return CLIP_ARCHS[model_name]
    if model_name.startswith("openai/CLIP/"):
        arch = model_name[len("openai/CLIP/"):]
        if arch in CLIP_ARCHS:
            return CLIP_ARCHS[arch]
    if model_name.startswith("facebookresearch/SLIP/"):
        arch = model_name[len("facebookresearch/SLIP/"):]
        if arch in SLIP_ARCHS:
            return SLIP_ARCHS[arch]
    if model_name.startswith("m-bain/frozen-in-time/"):
        arch = model_name[len("m-bain/frozen-in-time/"):]
        if arch in FIT_ARCHS:
            return FIT_ARCHS[arch]
    raise NotImplementedError(
        f"{model_name} not found, should be one of.. {VALID_MODELS}"
    )


def alias_name(model_name: str) -> str:
    """Reference alias scheme (debias_clip/model/model.py:114):
    ``openai/CLIP/ViT-B/16`` → ``oai-clip-vit-b-16``."""
    if model_name.startswith("openai/CLIP/"):
        return "oai-clip-" + "-".join(model_name.split("/")[2:]).lower()
    if model_name.startswith("facebookresearch/SLIP/"):
        return "fb-slip-" + "-".join(model_name.split("/")[2:]).lower()
    if model_name.startswith("m-bain/frozen-in-time/"):
        return "mbain-fit-" + "-".join(model_name.split("/")[2:]).lower()
    return model_name.replace("/", "-").lower()
