"""Frozen-in-Time video-text dual encoder (m-bain/frozen-in-time family).

Counterpart of ``debias_vision_lang_tpu/models/frozen_in_time.py``.  The
video tower is a ViT over space-time patch tokens: each frame's patch
tokens take the spatial positions (the class slot skipped, shared across
frames) and a learned temporal embedding per frame.  Two formulations:
  * "joint": one attention over [CLS] + T*N tokens (S = 1 + 4 * 196 = 785
    at ViT-B/16 over 4 frames), pooled at the class token;
  * "divided" (upstream FiT's, TimeSformer-style): per block, attention
    over the T frames at each location (``temporal_attn``, its output
    projection zero at init, so the path starts as the identity), then
    attention within each frame, then the MLP; mean-pooled over all T*N
    tokens, no class token.
Both apply ``ln_pre``; the MLP runs the exact erf GELU (a timm tower).  The
text tower is CLIP's (upstream's DistilBERT is not kept, as in the JAX
package), and images [B, H, W, 3] are 1-frame videos.

Routing, as in the JAX package: float32 and bfloat16 run the plain layers
(``layers.transformer`` / ``multi_head_attention``: matrix products and the
plain attention); ``fused`` is accepted and ignored, as the JAX
``encode_image`` pops it for every tower that is not an image ViT;
``use_pallas=True`` sends every attention to K5 (``ops/attention.py``: the
long route at the joint tower's 785 tokens, the short one at the divided
tower's 4 and 196).  The int8 towers are ``ops/quant.py``'s.

Parameters keep the JAX tree's names: ``visual.temporal_embedding``
[frames, D], ``visual.temporal_attn.ln_t.*`` and
``visual.temporal_attn.attn.{wqkv, bqkv, wo, bo}`` stacked on a leading
layer axis, ``visual.proj.kernel`` / ``visual.proj.bias`` (upstream's
``vid_proj`` Linear), and a conv bias.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import CLIPConfig, VisionConfig
from .clip import CLIP, PatchConv, _vector, init_clip_params, patch_embed
from .layers import (LayerNorm, gelu, layer_norm, linear, make_resblocks,
                     multi_head_attention, transformer)

DEFAULT_NUM_FRAMES = 4
VIDEO_ATTENTIONS = ("joint", "divided")


def _fit_act(cfg: VisionConfig) -> Callable:
    """Upstream FiT's video tower is a timm ViT: the exact (erf) GELU."""
    del cfg
    return gelu


def _project(x: torch.Tensor, proj, dtype) -> torch.Tensor:
    """The final projection: a bare matrix (CLIP's) or a ``Projection``
    (upstream FiT's ``vid_proj`` Linear, with a bias)."""
    if isinstance(proj, torch.Tensor):
        return x @ proj.to(dtype)
    return x @ proj.kernel.to(dtype) + proj.bias.to(dtype)


class Projection(nn.Module):
    """A Linear in the JAX layout: kernel [in, out] and bias [out]."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = _vector(d_in, d_out)
        self.bias = _vector(d_out)


class TemporalAttention(nn.Module):
    """The divided tower's per-block temporal attention, stacked on a leading
    layer axis as in the JAX tree: ``ln_t`` (scale, bias [L, D]) and ``attn``
    (wqkv [L, D, 3D], bqkv [L, 3D], wo [L, D, D], bo [L, D])."""

    def __init__(self, layers: int, width: int):
        super().__init__()
        self.ln_t = nn.Module()
        self.ln_t.scale = nn.Parameter(torch.ones(layers, width))
        self.ln_t.bias = _vector(layers, width)
        self.attn = nn.Module()
        self.attn.wqkv = _vector(layers, width, 3 * width)
        self.attn.bqkv = _vector(layers, 3 * width)
        self.attn.wo = _vector(layers, width, width)
        self.attn.bo = _vector(layers, width)

    def layer(self, i: int):
        """Layer i's (LayerNorm, attention) as views the plain layers take."""
        a = self.attn
        return (SimpleNamespace(scale=self.ln_t.scale[i], bias=self.ln_t.bias[i]),
                SimpleNamespace(wqkv=a.wqkv[i], bqkv=a.bqkv[i], wo=a.wo[i], bo=a.bo[i]))


class VideoVisionTransformer(nn.Module):
    """The video tower (kind ``video_vit``); ``forward`` runs the formulation
    ``attention`` names, else the config's ``video_attention``."""

    def __init__(self, cfg: VisionConfig, num_frames: int = DEFAULT_NUM_FRAMES):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = PatchConv(cfg.patch_size * cfg.patch_size * 3, w, bias=True)
        self.class_embedding = _vector(w)
        self.positional_embedding = _vector(cfg.seq_len, w)
        self.temporal_embedding = _vector(num_frames, w)
        self.ln_pre = LayerNorm(w)
        self.resblocks = make_resblocks(cfg.layers, w)
        self.ln_post = LayerNorm(w)
        self.proj = Projection(w, cfg.embed_dim)
        self.temporal_attn = TemporalAttention(cfg.layers, w)

    def forward(self, videos: torch.Tensor, dtype=None, fused: Optional[bool] = None,
                use_pallas: Optional[bool] = None, remat: bool = False,
                attention: Optional[str] = None) -> torch.Tensor:
        del fused  # the image ViT's fused-block knob: the video towers run plain
        mode = attention or self.cfg.video_attention
        if mode not in VIDEO_ATTENTIONS:
            raise ValueError(f"attention must be one of {VIDEO_ATTENTIONS}, got {mode!r}")
        fn = encode_video_divided if mode == "divided" else encode_video
        return fn(self, videos, dtype=dtype or torch.float32, use_pallas=use_pallas,
                  remat=remat)


@torch.no_grad()
def init_video_vit_params(v: VideoVisionTransformer, generator: torch.Generator) -> None:
    """The JAX package's ``init_video_vit_params`` scheme in place (after the
    ViT's own init of conv1, embeddings, resblocks and proj.kernel): the conv
    bias, proj.bias and temporal embedding zero, and
    ``init_temporal_attn_params``'s temporal attention."""
    v.conv1.bias.zero_()
    v.proj.bias.zero_()
    v.temporal_embedding.zero_()
    init_temporal_attn_params(v.temporal_attn, generator)


@torch.no_grad()
def init_temporal_attn_params(ta: TemporalAttention, generator: torch.Generator) -> None:
    """Upstream FiT's identity trick: LayerNorms at identity, the QKV
    projection drawn as CLIP's in-projection (std width^-0.5), and the
    OUTPUT projection zero, so the fresh temporal path adds nothing."""
    width = ta.attn.wqkv.shape[1]
    ta.ln_t.scale.fill_(1.0)
    ta.ln_t.bias.zero_()
    ta.attn.wqkv.copy_(torch.randn(ta.attn.wqkv.shape, generator=generator) * width ** -0.5)
    for p in (ta.attn.bqkv, ta.attn.wo, ta.attn.bo):
        p.zero_()


def frame_indices(t: int, max_t: int) -> torch.Tensor:
    """``jnp.linspace(0, t - 1, max_t).astype(int32)`` bit for bit: float32
    steps i / (max_t - 1), start * (1 - step) + stop * step, the stop
    itself last, truncated toward zero."""
    div = max_t - 1
    stop = torch.tensor(float(t - 1), dtype=torch.float32)
    step = torch.arange(div, dtype=torch.float32) / torch.tensor(float(div))
    out = torch.cat([0.0 * (1 - step) + stop * step, stop[None]])
    return out.to(torch.int32).long()


def _video_tokens(v: VideoVisionTransformer, videos: torch.Tensor, dtype,
                  patch_embed_fn: Optional[Callable] = None):
    """The prologue of both formulations: [B, T, H, W, 3] (4-D promoted to
    one frame) -> per-frame patch tokens [B, T, N, D] with the spatial
    positions (slots 1..N, shared across frames) and the temporal
    embedding added; more frames than the embedding holds are subsampled
    uniformly.  ``patch_embed_fn`` ([B*T, H, W, 3] -> tokens) replaces the
    stem (the int8 tower's).  Returns (tokens, b, t, n)."""
    cfg = v.cfg
    if videos.dim() == 4:
        videos = videos[:, None]
    b, t, h, w, c = videos.shape
    max_t = v.temporal_embedding.shape[0]
    if t > max_t:
        videos = videos[:, frame_indices(t, max_t).to(videos.device)]
        t = max_t
    frames = videos.reshape(b * t, h, w, c)
    if patch_embed_fn is None:
        x = patch_embed(v.conv1.kernel, frames.to(dtype), cfg.patch_size, v.conv1.bias)
    else:
        x = patch_embed_fn(frames)
    n = x.shape[1]
    x = x.reshape(b, t, n, cfg.width)
    x = x + v.positional_embedding.to(dtype)[1: n + 1][None, None]
    x = x + v.temporal_embedding.to(dtype)[:t][None, :, None, :]
    return x, b, t, n


def _class_and_ln_pre(v: VideoVisionTransformer, x: torch.Tensor, dtype) -> torch.Tensor:
    """[B, T, N, D] tokens -> LN_pre([CLS] + T*N tokens) for the joint tower."""
    b, t, n, w = x.shape
    cls = v.class_embedding.to(dtype) + v.positional_embedding.to(dtype)[0]
    x = torch.cat([cls.expand(b, 1, w), x.reshape(b, t * n, w)], dim=1)
    return layer_norm(v.ln_pre, x)


def encode_video(v: VideoVisionTransformer, videos: torch.Tensor, *, dtype=torch.float32,
                 use_pallas: Optional[bool] = None, remat: bool = False) -> torch.Tensor:
    """Joint space-time attention: [B, T, H, W, 3] (or [B, H, W, 3]) ->
    [B, embed_dim]."""
    x, _, _, _ = _video_tokens(v, videos, dtype)
    x = _class_and_ln_pre(v, x, dtype)
    x = transformer(v.resblocks, x, v.cfg.heads, mask=None, act=_fit_act(v.cfg),
                    use_pallas=use_pallas, remat=remat)
    x = layer_norm(v.ln_post, x[:, 0, :])
    return _project(x, v.proj, dtype)


def _divided_block(v: VideoVisionTransformer, i: int, x: torch.Tensor,
                   use_pallas: Optional[bool]) -> torch.Tensor:
    """Block i of the divided tower on [B, T, N, D]: temporal attention at
    each location, spatial attention within each frame, then the MLP."""
    b, t, n, w = x.shape
    heads = v.cfg.heads
    sp = v.resblocks[i]
    tp_ln, tp_attn = v.temporal_attn.layer(i)
    xt = x.transpose(1, 2).reshape(b * n, t, w)
    at = multi_head_attention(tp_attn, layer_norm(tp_ln, xt), heads, use_pallas=use_pallas)
    x = x + at.reshape(b, n, t, w).transpose(1, 2)
    xs = x.reshape(b * t, n, w)
    asp = multi_head_attention(sp.attn, layer_norm(sp.ln_1, xs), heads, use_pallas=use_pallas)
    x = x + asp.reshape(b, t, n, w)
    hdn = linear(layer_norm(sp.ln_2, x), sp.mlp.w1, sp.mlp.b1)
    return x + linear(gelu(hdn), sp.mlp.w2, sp.mlp.b2)


def _mean_pool_project(v: VideoVisionTransformer, x: torch.Tensor, dtype) -> torch.Tensor:
    """The divided tower's head: mean over all T*N tokens, LN_post, proj."""
    b, t, n, w = x.shape
    pooled = x.reshape(b, t * n, w).mean(dim=1)
    return _project(layer_norm(v.ln_post, pooled), v.proj, dtype)


def encode_video_divided(v: VideoVisionTransformer, videos: torch.Tensor, *,
                         dtype=torch.float32, use_pallas: Optional[bool] = None,
                         remat: bool = False) -> torch.Tensor:
    """Divided space-time attention (upstream FiT's formulation): [B, T, H,
    W, 3] -> [B, embed_dim]; ``remat`` checkpoints each block."""
    x, _, _, _ = _video_tokens(v, videos, dtype)
    x = layer_norm(v.ln_pre, x)
    for i in range(len(v.resblocks)):
        if remat:
            x = checkpoint(_divided_block, v, i, x, use_pallas, use_reentrant=False)
        else:
            x = _divided_block(v, i, x, use_pallas)
    return _mean_pool_project(v, x, dtype)


def init_fit_params(cfg: CLIPConfig, generator: Optional[torch.Generator] = None):
    """Random float32 parameters of a Frozen-in-Time bundle as a ``CLIP``
    state dict (``init_clip_params`` builds the video tower for a
    ``video_vit`` config)."""
    if cfg.vision.kind != "video_vit":
        raise ValueError(f"init_fit_params takes a video_vit config, got {cfg.vision.kind!r}")
    return init_clip_params(cfg, generator)


def formulation(model) -> Optional[str]:
    """The video formulation a bundle's image embeddings come from: the
    ``attention`` of the ``FrozenInTime`` under any wrapper (QuantizedCLIP's
    ``base``, DebiasCLIP's ``clip``), else its config's ``video_attention``;
    None for a bundle without a video tower."""
    base = getattr(model, "base", model)
    clip = getattr(base, "clip", base)
    cfg = getattr(clip, "cfg", None)
    vis = getattr(cfg, "vision", None)
    if getattr(vis, "kind", None) != "video_vit":
        return None
    return getattr(clip, "attention", None) or vis.video_attention


class FrozenInTime(CLIP):
    """The video family's bundle: a ``CLIP`` whose image tower is the video
    tower, with ``attention`` in ("joint", "divided") (default: the config's
    ``video_attention``).  ``encode_image`` takes images as 1-frame videos
    and [B, T, H, W, 3] videos alike (``encode_video`` is the same call).
    ``load_state_dict`` adds a zero temporal embedding to a state dict that
    carries none, as the JAX bundle does for image-ViT parameters."""

    def __init__(self, cfg: CLIPConfig, attention: Optional[str] = None):
        if cfg.vision.kind != "video_vit":
            raise ValueError(f"FrozenInTime takes a video_vit config, got {cfg.vision.kind!r}")
        attention = attention or cfg.vision.video_attention
        if attention not in VIDEO_ATTENTIONS:
            raise ValueError(f"attention must be 'joint' or 'divided', got {attention!r}")
        super().__init__(cfg)
        self.attention = attention

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        if "visual.temporal_embedding" not in state_dict:
            state_dict = {**state_dict, "visual.temporal_embedding": torch.zeros(
                DEFAULT_NUM_FRAMES, self.cfg.vision.width)}
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def encode_image(self, images, dtype=None, fused=None, use_pallas=None,
                     remat=False) -> torch.Tensor:
        return self.visual(images, dtype=dtype, fused=fused, use_pallas=use_pallas,
                           remat=remat, attention=self.attention)

    encode_video = encode_image
