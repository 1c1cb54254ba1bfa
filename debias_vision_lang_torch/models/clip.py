"""CLIP dual encoder (image tower + causal text tower) as ``nn.Module``s.

Counterpart of ``debias_vision_lang_tpu/models/clip.py`` for the "vit"
(OpenAI CLIP), "slip_vit" (facebookresearch/SLIP, a timm ViT), "resnet"
(OpenAI CLIP's ModifiedResNet, ``models/resnet.py``) and "video_vit"
(Frozen-in-Time, ``models/frozen_in_time.py``: the formulation comes from
``cfg.vision.video_attention``) towers.
The SLIP tower's patch conv has a bias, it has no pre-LN, and its MLP runs
the exact erf GELU: ``act_kind="gelu"`` (the A&S polynomial) in the fused
blocks, ``layers.gelu`` in the plain tower, as in the JAX package.
The text tower is exposed piecewise -- ``embed_tokens`` / ``add_positional``
/ ``run_text_transformer`` / ``project_eot`` -- because prompt injection
(models/debias.py) happens between embedding and transformer.

Fused-block gate (as ``_use_fused_blocks``): a bfloat16 tower runs its
layers through ``ops/fused_block.py`` -- the CUDA kernels on a CUDA tensor,
their plain twins on a CPU tensor; a float32 tower, or any tower asked for
``use_pallas`` (the attention kernel), runs the plain ``layers.transformer``.
``fused=`` overrides the choice.  With grad mode on and any input needing
a gradient, the fused tower is the differentiable ``fused_transformer_diff``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.config import CLIPConfig, TextConfig, VisionConfig
from ..ops.fused_block import fused_transformer, fused_transformer_diff
from ..vision.preprocess import CLIP_MEAN, CLIP_STD
from .layers import (LayerNorm, causal_mask, gelu, init_resblocks, layer_norm,
                     make_resblocks, quick_gelu, transformer)
from .resnet import ModifiedResNet, init_modified_resnet_params

VIT_KINDS = ("vit", "slip_vit")
TOWER_KINDS = VIT_KINDS + ("resnet", "video_vit")  # every image tower the port builds


def unknown_tower(kind) -> NotImplementedError:
    """The error for a vision kind the port does not build."""
    return NotImplementedError(f"vision tower kind {kind!r}: the port builds "
                               f"{', '.join(TOWER_KINDS)}")


def _vector(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


class PatchConv(nn.Module):
    """Patch projection stored as a matrix: kernel [patch*patch*3, width],
    input rows in (row, col, channel) order; SLIP's carries a bias."""

    def __init__(self, patch_dim: int, width: int, bias: bool = False):
        super().__init__()
        self.kernel = _vector(patch_dim, width)
        self.bias = _vector(width) if bias else None


class VisionTransformer(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        if cfg.kind not in VIT_KINDS:
            raise unknown_tower(cfg.kind)
        self.cfg = cfg
        w = cfg.width
        slip = cfg.kind == "slip_vit"
        self.conv1 = PatchConv(cfg.patch_size * cfg.patch_size * 3, w, bias=slip)
        self.class_embedding = _vector(w)
        self.positional_embedding = _vector(cfg.seq_len, w)
        self.ln_pre = None if slip else LayerNorm(w)
        self.resblocks = make_resblocks(cfg.layers, w)
        self.ln_post = LayerNorm(w)
        self.proj = _vector(w, cfg.embed_dim)

    def forward(self, images: torch.Tensor, dtype=None,
                fused: Optional[bool] = None, use_pallas: Optional[bool] = None,
                remat: bool = False) -> torch.Tensor:
        kw = {"fused": fused, "use_pallas": use_pallas, "remat": remat}
        if is_patch_staging(images, self.cfg):
            return encode_image_vit_p8(self, images, dtype=dtype or torch.bfloat16,
                                       **kw)
        return encode_image_vit(self, images, dtype=dtype or torch.float32, **kw)


class TextTransformer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = _vector(cfg.vocab_size, cfg.width)
        self.positional_embedding = _vector(cfg.context_length, cfg.width)
        self.resblocks = make_resblocks(cfg.layers, cfg.width)
        self.ln_final = LayerNorm(cfg.width)
        self.text_projection = _vector(cfg.width, cfg.embed_dim)

    def forward(self, text: torch.Tensor, dtype=torch.float32,
                fused: Optional[bool] = None, use_pallas: Optional[bool] = None,
                remat: bool = False) -> torch.Tensor:
        x = add_positional(self, embed_tokens(self, text, dtype))
        x = run_text_transformer(self, x, fused=fused, use_pallas=use_pallas,
                                 remat=remat)
        return project_eot(self, x, text)


class CLIP(nn.Module):
    """Vanilla CLIP bundle (``models/loader.py::CLIP`` in the JAX package)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        kind = cfg.vision.kind
        if kind == "resnet":
            self.visual = ModifiedResNet(cfg.vision)
        elif kind == "video_vit":
            from .frozen_in_time import VideoVisionTransformer

            self.visual = VideoVisionTransformer(cfg.vision)
        else:
            self.visual = VisionTransformer(cfg.vision)
        self.text = TextTransformer(cfg.text)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def encode_image(self, images, dtype=None, fused=None, use_pallas=None,
                     remat=False) -> torch.Tensor:
        return self.visual(images, dtype=dtype, fused=fused,
                           use_pallas=use_pallas, remat=remat)

    def encode_text(self, text, dtype=torch.float32, fused=None,
                    use_pallas=None, remat=False) -> torch.Tensor:
        return self.text(text, dtype=dtype, fused=fused, use_pallas=use_pallas,
                         remat=remat)

    def forward(self, images, text, dtype=None):
        img = self.encode_image(images, dtype=dtype).float()
        txt = self.encode_text(text, dtype=dtype or torch.float32).float()
        return logits(img, txt, self.logit_scale)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_clip_params(cfg: CLIPConfig,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
    """Random float32 parameters (OpenAI CLIP's init scheme, as the JAX
    package's ``init_clip_params``) as a ``CLIP(cfg)`` state dict, on the
    CPU; a SLIP tower's conv bias starts at zero, a ResNet tower takes
    ``init_modified_resnet_params``, a video tower the ViT's scheme and then
    ``frozen_in_time.init_video_vit_params``.  The numbers differ from
    jax.random's for the same seed."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = CLIP(cfg)
    v, t = model.visual, model.text
    vc = cfg.vision
    scale = vc.width ** -0.5

    def nrm(p: nn.Parameter, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    with torch.no_grad():
        if vc.kind == "resnet":
            init_modified_resnet_params(v, generator)
        else:
            nrm(v.conv1.kernel, v.conv1.kernel.shape[0] ** -0.5)
            nrm(v.class_embedding, scale)
            nrm(v.positional_embedding, scale)
            init_resblocks(v.resblocks, generator)
            if vc.kind == "video_vit":
                from .frozen_in_time import init_video_vit_params

                nrm(v.proj.kernel, scale)
                init_video_vit_params(v, generator)
            else:
                nrm(v.proj, scale)
        nrm(t.token_embedding, 0.02)
        nrm(t.positional_embedding, 0.01)
        init_resblocks(t.resblocks, generator)
        nrm(t.text_projection, cfg.text.width ** -0.5)
    return model.state_dict()


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------


def _use_fused_blocks(dtype, use_pallas: Optional[bool] = None,
                      fused: Optional[bool] = None) -> bool:
    """As JAX ``clip.py::_use_fused_blocks``: ``fused`` decides when given;
    otherwise ``use_pallas`` turns the fused blocks off at every dtype, and
    bfloat16 turns them on (on every device: a CPU tensor runs the twins)."""
    if fused is not None:
        return bool(fused)
    if use_pallas:
        return False
    return dtype == torch.bfloat16


def _fused_tower(blocks, x: torch.Tensor, heads: int, **kw) -> torch.Tensor:
    """The fused blocks, differentiable when a gradient can flow."""
    if torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in blocks.parameters())):
        return fused_transformer_diff(blocks, x, heads, **kw)
    return fused_transformer(blocks, x, heads, **kw)


def patch_embed(kernel: torch.Tensor, images: torch.Tensor, patch: int,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, W, 3] NHWC -> [B, num_patches, width], contracting the split
    patch dims directly (no patchified copy); f32 accumulation, rounded to
    the images' dtype, then the conv bias (SLIP's) added in that dtype."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x5 = images.reshape(b, gh, patch, gw, patch * c)
    k3 = kernel.to(images.dtype).reshape(patch, patch * c, kernel.shape[-1])
    out = torch.einsum("bgpwq,pqd->bgwd", x5.float(), k3.float())
    out = out.reshape(b, gh * gw, k3.shape[-1]).to(images.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def fold_preprocess_into_patch(kernel: torch.Tensor, mean=None, std=None,
                               bias: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absorb CLIP's Normalize into the patch weights: conv(normalize(u8)) ==
    u8 @ W' + b' with W'[i] = W[i] / (255 std[c]) and b' = sum_i
    (-mean[c] / std[c]) W[i] (c = channel of input row i), plus the conv
    bias where the tower has one (SLIP).  f32 results."""
    k = kernel.float()
    mean = torch.tensor(CLIP_MEAN if mean is None else mean, dtype=torch.float32,
                        device=k.device)
    std = torch.tensor(CLIP_STD if std is None else std, dtype=torch.float32,
                       device=k.device)
    c = torch.arange(k.shape[0], device=k.device) % 3
    w_f = k * (1.0 / (255.0 * std))[c][:, None]
    b_f = (-mean / std)[c] @ k
    if bias is not None:
        b_f = b_f + bias.float()
    return w_f, b_f


def _vit_trunk(v: VisionTransformer, x: torch.Tensor, dtype,
               fused: Optional[bool], use_pallas: Optional[bool] = None,
               remat: bool = False) -> torch.Tensor:
    """cls / positions / pre-LN (OpenAI's only) -> transformer -> post-LN /
    projection."""
    cfg = v.cfg
    cls = v.class_embedding.to(dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + v.positional_embedding.to(dtype)
    if v.ln_pre is not None:
        x = layer_norm(v.ln_pre, x)
    slip = cfg.kind == "slip_vit"
    if _use_fused_blocks(dtype, use_pallas, fused):
        x = _fused_tower(v.resblocks, x, cfg.heads,
                         act_kind="gelu" if slip else "quick_gelu")
    else:
        x = transformer(v.resblocks, x, cfg.heads, act=gelu if slip else quick_gelu,
                        use_pallas=use_pallas, remat=remat)
    x = layer_norm(v.ln_post, x[:, 0, :])
    return x @ v.proj.to(dtype)


def encode_image_vit(v: VisionTransformer, images: torch.Tensor, *,
                     dtype=torch.float32, fused: Optional[bool] = None,
                     use_pallas: Optional[bool] = None, remat: bool = False
                     ) -> torch.Tensor:
    """ViT forward from normalized [B, H, W, 3] images -> [B, embed_dim]."""
    x = patch_embed(v.conv1.kernel, images.to(dtype), v.cfg.patch_size,
                    v.conv1.bias)
    return _vit_trunk(v, x, dtype, fused, use_pallas, remat)


def encode_image_vit_p8(v: VisionTransformer, patches_u8: torch.Tensor, *,
                        dtype=torch.bfloat16, fused: Optional[bool] = None,
                        use_pallas: Optional[bool] = None, remat: bool = False
                        ) -> torch.Tensor:
    """ViT forward from patch-contiguous uint8 staging [B, P, patch*patch*3]:
    the normalize is folded into the patch weights and the stem is one
    matmul (uint8 values are exact in bfloat16)."""
    cfg = v.cfg
    w_f, b_f = fold_preprocess_into_patch(v.conv1.kernel, cfg.image_mean,
                                          cfg.image_std, v.conv1.bias)
    x = torch.matmul(patches_u8.to(dtype).float(), w_f.to(dtype).float())
    x = x.to(dtype) + b_f.to(dtype)
    return _vit_trunk(v, x, dtype, fused, use_pallas, remat)


def is_patch_staging(images: torch.Tensor, cfg: VisionConfig) -> bool:
    """True iff ``images`` is the uint8 [B, (n/patch)^2, patch^2*3] staging."""
    return (images.dim() == 3 and images.dtype == torch.uint8
            and images.shape[-1] == cfg.patch_size * cfg.patch_size * 3
            and images.shape[-2] == (cfg.image_size // cfg.patch_size) ** 2)


# ---------------------------------------------------------------------------
# Text tower, piecewise
# ---------------------------------------------------------------------------


def embed_tokens(t: TextTransformer, text: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    return t.token_embedding.to(dtype)[text]


def add_positional(t: TextTransformer, x: torch.Tensor) -> torch.Tensor:
    return x + t.positional_embedding.to(x.dtype)[: x.shape[1]]


def run_text_transformer(t: TextTransformer, x: torch.Tensor,
                         fused: Optional[bool] = None,
                         use_pallas: Optional[bool] = None,
                         remat: bool = False) -> torch.Tensor:
    """Causal transformer over embedded text, then the final LayerNorm."""
    if _use_fused_blocks(x.dtype, use_pallas, fused):
        x = _fused_tower(t.resblocks, x, t.cfg.heads, causal=True)
    else:
        x = transformer(t.resblocks, x, t.cfg.heads,
                        mask=causal_mask(x.shape[1], x.device),
                        use_pallas=use_pallas, remat=remat)
    return layer_norm(t.ln_final, x)


def project_eot(t: TextTransformer, x: torch.Tensor,
                text: torch.Tensor) -> torch.Tensor:
    """Pool at the EOT position (argmax of the ids: EOT is the largest id)."""
    return pool_and_project(t, x, text.argmax(-1))


def pool_and_project(t: TextTransformer, x: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    pooled = x[torch.arange(x.shape[0], device=x.device), idx]
    return pooled @ t.text_projection.to(x.dtype)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)


def logits(img: torch.Tensor, txt: torch.Tensor, logit_scale: torch.Tensor):
    """(logits_per_image, logits_per_text) from unnormalized embeddings."""
    per_image = logit_scale.exp() * l2_normalize(img) @ l2_normalize(txt).T
    return per_image, per_image.T
