"""DebiasCLIP: a CLIP dual encoder plus learned prompt tokens injected into
the embedded text sequence.

Counterpart of ``debias_vision_lang_tpu/models/debias.py``, with the
reference's parity quirks kept:
  * ``prepend``: learned tokens get NO positional embedding; the shifted raw
    tokens keep their original positions; the last P raw slots are cut.
  * EOT pooling uses ``argmax(text) + P`` clamped to the last slot, for
    every placement mode.
  * ``zeros`` init is the embedding OF TOKEN ID 0, not zero vectors.
The freezing policy (``trainable_mask``, the reference's requires_grad
walk, model/model.py:291-334) is a dict of 0/1 multipliers keyed by the
CLIP module's parameter names; the port's resblocks are one module per
layer, so the JAX package's per-layer slice masks become per-module ones.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.config import CLIPConfig, DebiasConfig, Dotdict, debias_config_from_dotdict
from . import clip as clip_model
from .clip import CLIP


def init_debias_tokens(clip: CLIP, cfg: DebiasConfig,
                       tokenizer: Optional[Callable] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The learnable prompt array [P, hidden_dim] (float32, CPU)."""
    p = cfg.num_debias_tokens
    table = clip.text.token_embedding.detach().float().cpu()
    init = cfg.debias_token_init
    if init == "rand":  # nn.Embedding's default N(0, 1)
        return torch.randn((p, cfg.hidden_dim), generator=generator)
    if init == "zeros":  # the embedding of token id 0
        return table[0].expand(p, cfg.hidden_dim).clone()
    if isinstance(init, (list, tuple)):
        if tokenizer is None:
            raise ValueError("word-list debias_token_init requires a tokenizer")
        words = list(init)
        toks = np.asarray(tokenizer([" ".join(words)]))[0][1: len(words) + 1]
        return table[torch.as_tensor(toks, dtype=torch.long)].clone()
    raise NotImplementedError(f"debias_token_init={init!r}")


def _interval_insert(raw, debias, lo, hi):
    """Per row: slots lo <= j < hi take debias[j - lo], the rest keep raw."""
    _, s, _ = raw.shape
    j = torch.arange(s, device=raw.device)[None, :]
    inside = (j >= lo[:, None]) & (j < hi[:, None])
    idx = torch.clamp(j - lo[:, None], 0, debias.shape[0] - 1)
    return torch.where(inside[..., None], debias[idx], raw)


def inject_prompts(raw: torch.Tensor, debias_tokens: torch.Tensor,
                   text: torch.Tensor, mode: str) -> torch.Tensor:
    """raw [B, S, D] (token embeddings + positions), debias_tokens [P, D],
    text [B, S] ids -> the sequence the transformer sees."""
    p = debias_tokens.shape[0]
    if p == 0:
        return raw
    b, s, d = raw.shape
    deb = debias_tokens.to(raw.dtype)
    if mode == "prepend":
        return torch.cat([deb[None].expand(b, p, d), raw[:, : s - p]], dim=1)
    eot = text.argmax(-1)  # EOT is the largest id
    if mode == "append":  # overwrite starting AT the EOT slot
        return _interval_insert(raw, deb, eot, eot + torch.clamp(s - eot - 1, max=p))
    if mode == "append_after_eos":
        return _interval_insert(raw, deb, eot + 1, torch.clamp(eot + 1 + p, max=s))
    if mode == "add":
        pad = torch.zeros((s, d), dtype=raw.dtype, device=raw.device)
        pad[1: 1 + p] = deb
        return raw + pad[None]
    raise NotImplementedError(mode)


def debias_eot_index(text: torch.Tensor, num_debias_tokens: int,
                     seq_len: int) -> torch.Tensor:
    return torch.clamp(text.argmax(-1) + num_debias_tokens, max=seq_len - 1)


# ---------------------------------------------------------------------------
# Freezing as gradient masks (reference: model/model.py:36-82, 291-334)
# ---------------------------------------------------------------------------

_PROJ = ("text.ln_final.", "text.text_projection", "visual.ln_post.", "visual.proj")
_LAYER = re.compile(r"(visual|text)\.resblocks\.(\d+)\.")


def _classify(name: str) -> str:
    if name == "logit_scale" or name.startswith(_PROJ):
        return "proj"
    if name.startswith("visual.resblocks."):
        return "image"
    if name.startswith("text.resblocks."):
        return "text"
    if name.startswith("text.token_embedding"):
        return "tokens"
    return "other"


def classify_params(clip: CLIP) -> Tuple[Dict[str, int], List[Dict[str, Any]]]:
    """The reference's ``clip_layers`` surface: ``({type: count}, [{"type",
    "index", "param", "name"}, ...])`` over the CLIP module's named
    parameters, types proj / image / text / tokens / other; the image and
    text counts are the towers' layer counts (``layer_counts``)."""
    metadata = {k: 0 for k in ("text", "image", "proj", "tokens", "other")}
    classed: List[Dict[str, Any]] = []
    for name, param in clip.named_parameters():
        kind = _classify(name)
        classed.append({"type": kind, "index": metadata[kind], "param": param,
                        "name": name})
        metadata[kind] += 1
    metadata.update(layer_counts(clip))
    return metadata, classed


def layer_counts(clip: CLIP) -> Dict[str, int]:
    """Per-tower resblock counts (reference metadata, model/model.py:74-80)."""
    return {"image": len(clip.visual.resblocks), "text": len(clip.text.resblocks)}


def trainable_mask(clip: CLIP, debias_cfg: DebiasConfig) -> Dict[str, float]:
    """{parameter name: 1.0 or 0.0}, 1.0 where the reference would leave
    ``requires_grad=True``: the 'proj' group (ln_final, text_projection,
    logit_scale, visual.ln_post, visual.proj) iff not ``freeze_proj``; the
    top ``n_train_{vid,text}_layers`` resblocks of each tower; nothing
    else (token and positional embeddings, stems, ...)."""
    counts = layer_counts(clip)
    n_text, n_vid = debias_cfg.n_train_text_layers, debias_cfg.n_train_vid_layers
    if not (counts["text"] >= n_text >= 0):
        raise ValueError(
            f"Number of trained text layers should be between 0 (no layers) and "
            f"{counts['text']} (all layers), not {n_text}")
    if not (counts["image"] >= n_vid >= 0):
        raise ValueError(
            f"Number of trained vid layers should be between 0 (no layers) and "
            f"{counts['image']} (all layers), not {n_vid}")
    proj_on = 0.0 if debias_cfg.freeze_proj else 1.0
    n_train = {"visual": (counts["image"], n_vid), "text": (counts["text"], n_text)}
    mask: Dict[str, float] = {}
    for name, _ in clip.named_parameters():
        layer = _LAYER.match(name)
        if layer:
            n_layers, n = n_train[layer.group(1)]
            mask[name] = 1.0 if int(layer.group(2)) >= n_layers - n else 0.0
        else:
            mask[name] = proj_on if _classify(name) == "proj" else 0.0
    return mask


def apply_grad_mask(grads: Mapping[str, torch.Tensor],
                    mask: Mapping[str, float]) -> Dict[str, torch.Tensor]:
    return {name: g * mask[name] for name, g in grads.items()}


class DebiasCLIP(nn.Module):
    """CLIP + prompt array; ``from_cfg`` mirrors the reference's UPPERCASE
    dict constructor and returns ``(model, preprocess, tokenizer, alias)``."""

    def __init__(self, clip: CLIP, debias_tokens: torch.Tensor,
                 debias_cfg: DebiasConfig):
        super().__init__()
        self.clip = clip
        self.debias_tokens = nn.Parameter(debias_tokens.float())
        self.debias_cfg = debias_cfg

    @property
    def clip_cfg(self) -> CLIPConfig:
        return self.clip.cfg

    @property
    def logit_scale(self) -> torch.Tensor:
        return self.clip.logit_scale

    def encode_text(self, text: torch.Tensor, dtype=torch.float32,
                    fused: Optional[bool] = None, use_pallas: Optional[bool] = None,
                    remat: bool = False) -> torch.Tensor:
        """Debiased text encoding: [B, 77] ids -> [B, embed_dim]."""
        t = self.clip.text
        raw = clip_model.add_positional(t, clip_model.embed_tokens(t, text, dtype))
        x = inject_prompts(raw, self.debias_tokens, text, self.debias_cfg.debias_pos)
        x = clip_model.run_text_transformer(t, x, fused=fused, use_pallas=use_pallas,
                                            remat=remat)
        idx = debias_eot_index(text, self.debias_tokens.shape[0], x.shape[1])
        return clip_model.pool_and_project(t, x, idx)

    def encode_image(self, images: torch.Tensor, dtype=None,
                     fused: Optional[bool] = None, use_pallas: Optional[bool] = None,
                     remat: bool = False) -> torch.Tensor:
        return self.clip.encode_image(images, dtype=dtype, fused=fused,
                                      use_pallas=use_pallas, remat=remat)

    def forward(self, images, text, dtype=None):
        img = self.encode_image(images, dtype=dtype).float()
        txt = self.encode_text(text, dtype=dtype or torch.float32).float()
        return clip_model.logits(img, txt, self.logit_scale)

    def trainable_mask(self) -> Dict[str, float]:
        return trainable_mask(self.clip, self.debias_cfg)

    @staticmethod
    def from_cfg(cfg: Union[dict, Dotdict],
                 generator: Optional[torch.Generator] = None, device="cuda"):
        """Build from an UPPERCASE-key config dict (extra keys ignored).
        Pretrained weights resolve as in ``model_loader``; ``PRETRAINED:
        False`` gives a random init from ``SEED``.  The model goes to the
        card unless ``device="cpu"``; with no card the default raises."""
        from ..utils.device import resolve_device
        from .loader import model_loader

        device = resolve_device(device)
        cfg = Dotdict(cfg)
        seed = int(cfg.SEED) if cfg.SEED is not None else 0
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        debias_cfg = debias_config_from_dotdict(cfg)
        base, preprocess, tokenizer, alias = model_loader(
            cfg.CLIP_ARCH, pretrained=True if cfg.PRETRAINED is None else bool(cfg.PRETRAINED),
            weights=cfg.WEIGHTS, seed=seed, device="cpu")
        if cfg.HIDDEN_DIM is None:
            debias_cfg = dataclasses.replace(debias_cfg, hidden_dim=base.cfg.text.width)
        if cfg._tokenizer is not None:
            tokenizer = cfg._tokenizer
        tokens = init_debias_tokens(base, debias_cfg, tokenizer, generator)
        model = DebiasCLIP(base, tokens, debias_cfg).to(device)
        return model, preprocess, tokenizer, alias
