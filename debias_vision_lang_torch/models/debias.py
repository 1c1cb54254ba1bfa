"""DebiasCLIP: a CLIP dual encoder plus learned prompt tokens injected into
the embedded text sequence.

Counterpart of ``debias_vision_lang_tpu/models/debias.py``, with the
reference's parity quirks kept:
  * ``prepend``: learned tokens get NO positional embedding; the shifted raw
    tokens keep their original positions; the last P raw slots are cut.
  * EOT pooling uses ``argmax(text) + P`` clamped to the last slot, for
    every placement mode.
  * ``zeros`` init is the embedding OF TOKEN ID 0, not zero vectors.
The freezing policy (``trainable_mask``) and training wait for the
training slice (ROADMAP.md queue 1 items 1-2).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from debias_vision_lang_tpu.core.config import (CLIPConfig, DebiasConfig, Dotdict,
                                                debias_config_from_dotdict)

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
                    fused: Optional[bool] = None) -> torch.Tensor:
        """Debiased text encoding: [B, 77] ids -> [B, embed_dim]."""
        t = self.clip.text
        raw = clip_model.add_positional(t, clip_model.embed_tokens(t, text, dtype))
        x = inject_prompts(raw, self.debias_tokens, text, self.debias_cfg.debias_pos)
        x = clip_model.run_text_transformer(t, x, fused=fused)
        idx = debias_eot_index(text, self.debias_tokens.shape[0], x.shape[1])
        return clip_model.pool_and_project(t, x, idx)

    def encode_image(self, images: torch.Tensor, dtype=None,
                     fused: Optional[bool] = None) -> torch.Tensor:
        return self.clip.encode_image(images, dtype=dtype, fused=fused)

    def forward(self, images, text, dtype=None):
        img = self.encode_image(images, dtype=dtype).float()
        txt = self.encode_text(text, dtype=dtype or torch.float32).float()
        return clip_model.logits(img, txt, self.logit_scale)

    @staticmethod
    def from_cfg(cfg: Union[dict, Dotdict],
                 generator: Optional[torch.Generator] = None, device=None):
        """Build from an UPPERCASE-key config dict (extra keys ignored).
        Pretrained weights resolve as in ``model_loader``; ``PRETRAINED:
        False`` gives a random init from ``SEED``."""
        from .loader import model_loader

        cfg = Dotdict(cfg)
        seed = int(cfg.SEED) if cfg.SEED is not None else 0
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        debias_cfg = debias_config_from_dotdict(cfg)
        base, preprocess, tokenizer, alias = model_loader(
            cfg.CLIP_ARCH, pretrained=True if cfg.PRETRAINED is None else bool(cfg.PRETRAINED),
            weights=cfg.WEIGHTS, seed=seed)
        if cfg.HIDDEN_DIM is None:
            debias_cfg = dataclasses.replace(debias_cfg, hidden_dim=base.cfg.text.width)
        if cfg._tokenizer is not None:
            tokenizer = cfg._tokenizer
        tokens = init_debias_tokens(base, debias_cfg, tokenizer, generator)
        model = DebiasCLIP(base, tokens, debias_cfg)
        if device is not None:
            model = model.to(device)
        return model, preprocess, tokenizer, alias
