"""Pretrained hub: ``load("ViT-B/16-gender")`` → drop-in debiased model.

Counterpart of ``debias_vision_lang_tpu/hub/hub.py`` (reference:
debias_clip/model/clip.py:45-82): look the name up in the registry, read
the checkpoint — which is ONLY the [P, width] prompt-embedding tensor —
build the base CLIP, wrap it in DebiasCLIP with those prompt weights, and
return ``(model, preprocess)`` on ``device``.

The port downloads nothing: a registry name resolves only to a file
already under ``download_root`` (default ``core/paths.py::CACHE_PATH``),
named as the URL's basename; a local checkpoint path (``.pt`` or ``.npz``)
loads directly.
"""

from __future__ import annotations

import os
import pathlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import DebiasConfig
from ..core.paths import CACHE_PATH
from ..core.registry import resolve_arch
from ..models.convert import load_debias_prompt_pt
from ..models.debias import DebiasCLIP
from ..models.loader import model_loader
from ..utils.device import resolve_device
from ..vision.preprocess import Preprocess

# name → {url, clip_arch, num_debias_tokens}: the port's copy of
# debias_vision_lang_tpu/data/download.py::PRETRAINED_PROMPTS
PRETRAINED_PROMPTS = {
    "ViT-B/16-gender": {
        "url": "https://www.robots.ox.ac.uk/~maxbain/oxai-bias/"
        "best_ndkl_oai-clip-vit-b-16_neptune_run_OXVLB-317_model_e4_step_5334_embeddings.pt",
        "clip_arch": "ViT-B/16",
        "num_debias_tokens": 2,
    }
}
_MODELS = PRETRAINED_PROMPTS


def available_models() -> List[str]:
    """Names of available pretrained debiased models (reference: model/clip.py:45-47)."""
    return list(_MODELS.keys())


def pretrained_prompts_path(name: str, root: Optional[os.PathLike] = None) -> str:
    """The local file of a registry checkpoint: ``root`` (default
    ``CACHE_PATH``) / the URL's basename.  It must exist already."""
    url = _MODELS[name]["url"]
    path = pathlib.Path(root or CACHE_PATH) / os.path.basename(url)
    if not path.is_file():
        raise FileNotFoundError(
            f"{name}: no prompt checkpoint at {path}; the port downloads "
            f"nothing: put the file ({url}) there, pass download_root=, or "
            "pass the checkpoint's path as the name")
    return str(path)


def _load_prompt_embeddings(path: str) -> torch.Tensor:
    if path.endswith(".npz"):
        with np.load(path) as data:
            return torch.from_numpy(np.asarray(data[data.files[0]], np.float32))
    return load_debias_prompt_pt(path)


def load(
    name: str,
    device="cuda",
    download_root: Optional[str] = None,
    pretrained_base: bool = True,
    base_weights: Optional[str] = None,
) -> Tuple[DebiasCLIP, Preprocess]:
    """Load a pretrained debiased CLIP onto ``device`` (the card unless
    ``"cpu"``; without a card the default raises).

    ``name``: a registry name (``available_models()``) or a path to a prompt-
    embedding checkpoint (then the base arch defaults to ViT-B/16, as the
    shipped checkpoint's — reference: model/clip.py:68-73).
    Returns ``(model, preprocess)``.
    """
    device = resolve_device(device)
    if name in _MODELS:
        entry = _MODELS[name]
        ckpt_path = pretrained_prompts_path(name, download_root)
    elif os.path.isfile(name):
        entry = _MODELS["ViT-B/16-gender"]
        ckpt_path = name
    else:
        raise RuntimeError(
            f"Model {name} not found; available models = {available_models()}"
        )

    prompt_emb = _load_prompt_embeddings(ckpt_path)
    shape = tuple(prompt_emb.shape)

    # fail fast: shape-validate against the ARCH config before paying the
    # full base-model build (same errors as the JAX package, same order)
    hidden_dim = int(
        resolve_arch(f"openai/CLIP/{entry['clip_arch']}").text.width)
    if name in _MODELS:
        # registry entries pin their token count — a mismatch means a
        # corrupt or wrong file
        n_tokens = int(entry["num_debias_tokens"])
        if shape != (n_tokens, hidden_dim):
            raise ValueError(
                f"checkpoint prompt shape {shape} != expected "
                f"({n_tokens}, {hidden_dim})"
            )
    else:
        # local user-trained checkpoints carry their own P: infer it from
        # the tensor (reference: model/clip.py:81); only the width must match
        if len(shape) != 2 or shape[1] != hidden_dim:
            raise ValueError(
                f"checkpoint prompt shape {shape} incompatible "
                f"with the {entry['clip_arch']} text width {hidden_dim}"
            )
        n_tokens = shape[0]

    base, preprocess, _tokenizer, _alias = model_loader(
        f"openai/CLIP/{entry['clip_arch']}", device="cpu",
        pretrained=pretrained_base, weights=base_weights)
    model = DebiasCLIP(
        base, prompt_emb,
        DebiasConfig(num_debias_tokens=n_tokens, hidden_dim=hidden_dim))
    return model.to(device), preprocess
