"""Int8 inference for the ViT families (OpenAI CLIP and SLIP): weight
quantization, the plain int8 layers, the int8 stems and towers, and
``QuantizedCLIP``.

Counterpart of ``debias_vision_lang_tpu/ops/quant.py`` ("vit" and
"slip_vit" towers):
symmetric per-output-channel int8 weights (``quantize_weight``, bit-exact
against the JAX function) and dynamic per-row int8 activations on the four
matmuls of every residual block; LayerNorms, softmax, residuals and the
dequantize stay floating point.  A bfloat16 tower runs its blocks through
``ops/fused_block_q.py`` (the CUDA kernels on a CUDA tensor, their twins on
a CPU tensor); ``fused=False`` runs the plain int8 layers here, whose
integer products go to ``torch._int_mm`` -- in the JAX package too they lie
outside any Pallas kernel.  So do the two stems.  A SLIP tower skips the
pre-LN and runs the erf GELU: ``act_kind="gelu"`` in the fused blocks, the
exact ``layers.gelu`` in the plain int8 layers; its conv bias rides on the
float stem and, folded, on the uint8 one.

Not ported: the resnet and video towers (ROADMAP.md queue 1 items 4b, 4c), the
TPU's hybrid long-sequence branch and VMEM gates, the u8 stem (off every
default path), and the "auto" rung (queue 1 item 8).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models.clip import (CLIP, ROADMAP_OTHER_TOWERS, VIT_KINDS, _use_fused_blocks,
                           add_positional, embed_tokens,
                           fold_preprocess_into_patch, is_patch_staging,
                           pool_and_project, project_eot)
from ..models.debias import DebiasCLIP, debias_eot_index, inject_prompts
from ..models.layers import attention_bshd, causal_mask, gelu, layer_norm, quick_gelu
from .fused_block_q import dot_q, fused_transformer_q, int_mm, quant_rows, true_div

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
INT8_RUNGS = ("int8", "int8-text")
ROADMAP_AUTO = ("ROADMAP.md queue 1 item 8 (the 'auto' rung, chosen from H100 "
                "measurements of every rung)")


def quantize_weight(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8: w [..., in, out] -> {"q": int8 of
    the same shape, "scale": f32 [..., 1, out]}, scale = max(amax / 127,
    1e-8), q = clip(round_half_even(w / scale), -127, 127)."""
    w = w.detach().float()
    scale = torch.clamp(true_div(w.abs().amax(-2, keepdim=True), 127.0), min=1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


class QWeight(nn.Module):
    """``quantize_weight(w)`` as buffers: ``q`` [in, out] int8 and ``scale``
    [1, out] f32 (the JAX layout), and ``qt``, q transposed to [out, in]:
    the K-contiguous copy that the CUDA kernels and cuBLAS's int8 GEMM read,
    made once here rather than on every call."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        qw = quantize_weight(w)
        self.register_buffer("q", qw["q"])
        self.register_buffer("scale", qw["scale"])
        self.register_buffer("qt", qw["q"].t().contiguous())


class QuantBlock(nn.Module):
    """One residual block with int8 matmul weights; the LayerNorms and
    biases are the float block's own parameters (shared, not copied)."""

    def __init__(self, blk):
        super().__init__()
        self.ln_1, self.ln_2 = blk.ln_1, blk.ln_2
        self.wqkv, self.wo = QWeight(blk.attn.wqkv), QWeight(blk.attn.wo)
        self.w1, self.w2 = QWeight(blk.mlp.w1), QWeight(blk.mlp.w2)
        self.bqkv, self.bo = blk.attn.bqkv, blk.attn.bo
        self.b1, self.b2 = blk.mlp.b1, blk.mlp.b2


def quantize_resblocks(blocks: nn.ModuleList) -> nn.ModuleList:
    """Quantize the four matmul weights of every residual block."""
    return nn.ModuleList(QuantBlock(blk) for blk in blocks)


# ---------------------------------------------------------------------------
# Plain int8 layers (the JAX package's XLA int8 path)
# ---------------------------------------------------------------------------


def int8_matmul(x: torch.Tensor, w: QWeight,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dynamic-activation int8 matmul: quantize x per row, exact int32
    product, dequantize (acc * row scale) * channel scale, + bias; in x's
    dtype."""
    xq, xs = quant_rows(x.float())
    out = dot_q(xq, xs, w.q, w.scale, w.qt)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def attn_residual_q(blk: QuantBlock, x: torch.Tensor, heads: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + out_proj(MHA(LN(x))) with int8 QKV / out-projection and the
    attention core in floating point (``layers.attention_bshd``)."""
    b, s, d = x.shape
    qkv = int8_matmul(layer_norm(blk.ln_1, x), blk.wqkv, blk.bqkv)
    q, k, v = (t.reshape(b, s, heads, d // heads) for t in qkv.split(d, -1))
    o = attention_bshd(q, k, v, mask).reshape(b, s, d)
    return x + int8_matmul(o, blk.wo, blk.bo)


def resblock_q(blk: QuantBlock, x: torch.Tensor, heads: int,
               mask: Optional[torch.Tensor] = None,
               act_kind: str = "quick_gelu") -> torch.Tensor:
    """Pre-LN residual block with int8 matmuls (attention core in fp);
    ``act_kind="gelu"`` is the exact erf GELU here, as on the JAX package's
    XLA int8 path."""
    act = {"quick_gelu": quick_gelu, "gelu": gelu}[act_kind]
    x = attn_residual_q(blk, x, heads, mask=mask)
    h = act(int8_matmul(layer_norm(blk.ln_2, x), blk.w1, blk.b1))
    return x + int8_matmul(h, blk.w2, blk.b2)


def transformer_q(blocks: nn.ModuleList, x: torch.Tensor, heads: int, *,
                  act_kind: str = "quick_gelu", causal: bool = False,
                  fused: Optional[bool] = None) -> torch.Tensor:
    """The int8 tower: the fused int8 blocks on bfloat16 activations (or
    ``fused=True``), the plain int8 layers otherwise (``causal`` as CLIP's
    additive text mask there)."""
    if _use_fused_blocks(x.dtype, fused=fused):
        return fused_transformer_q(blocks, x, heads, act_kind=act_kind,
                                   causal=causal)
    mask = causal_mask(x.shape[1], x.device) if causal else None
    for blk in blocks:
        x = resblock_q(blk, x, heads, mask=mask, act_kind=act_kind)
    return x


# ---------------------------------------------------------------------------
# Stems
# ---------------------------------------------------------------------------


def patch_embed_q(images: torch.Tensor, patch: int, w: QWeight,
                  bias: Optional[torch.Tensor] = None,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """Int8 patch embedding of float [B, H, W, C] images -> [B, P, width],
    with dynamic quantization per patch (amax over its patch^2 * C values)."""
    b, hh, ww, c = images.shape
    gh, gw = hh // patch, ww // patch
    width = w.q.shape[-1]
    x5 = images.float().reshape(b, gh, patch, gw, patch * c)
    amax = x5.abs().amax(dim=(2, 4), keepdim=True)
    x_scale = torch.clamp(true_div(amax, 127.0), min=1e-8)
    xq = torch.clamp(torch.round(x5 / x_scale), -127, 127).to(torch.int8)
    rows = xq.permute(0, 1, 3, 2, 4).reshape(b * gh * gw, patch * patch * c)
    acc = int_mm(rows, w.q, w.qt).reshape(b, gh, gw, width)
    out = acc.float() * x_scale[:, :, 0, :, 0][..., None] * w.scale[0]
    if bias is not None:
        out = out + bias.float()
    return out.reshape(b, gh * gw, width).to(out_dtype)


def patch_embed_q_p8(patches_u8: torch.Tensor, w: QWeight,
                     bias: Optional[torch.Tensor] = None,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """Integer-exact int8 patch embedding from patch-contiguous uint8
    staging [B, P, patch^2 * 3]: xq = u8 - 128 (lossless), acc = xq @ wq +
    128 * colsum(wq) == u8 @ wq in int32, out = acc * scale + bias.  Use with
    the normalize-folded weights."""
    b, p, k = patches_u8.shape
    xq = (patches_u8.to(torch.int32) - 128).to(torch.int8)
    acc = int_mm(xq.reshape(b * p, k), w.q, w.qt).reshape(b, p, -1)
    shift = 128 * w.q.to(torch.int32).sum(0)
    out = (acc + shift).float() * w.scale[0]
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------


class QuantVisual(nn.Module):
    """The int8 weights of a ``VisionTransformer``: the patch kernel (plain
    and normalize-folded) and the residual blocks.  Embeddings, LayerNorms
    and the projection are the float tower's (``visual``)."""

    def __init__(self, visual):
        super().__init__()
        cfg = visual.cfg
        self.visual = visual
        self.conv1 = QWeight(visual.conv1.kernel)
        bias = visual.conv1.bias
        w_f, b_f = fold_preprocess_into_patch(
            visual.conv1.kernel.detach(), cfg.image_mean, cfg.image_std,
            None if bias is None else bias.detach())
        self.conv1_folded = QWeight(w_f)
        self.register_buffer("conv1_bias_folded", b_f)
        self.resblocks = quantize_resblocks(visual.resblocks)


class QuantText(nn.Module):
    """The int8 residual blocks of a ``TextTransformer`` (``text``)."""

    def __init__(self, text):
        super().__init__()
        self.text = text
        self.resblocks = quantize_resblocks(text.resblocks)


def _vit_q_trunk(vq: QuantVisual, x: torch.Tensor, dtype,
                 fused: Optional[bool]) -> torch.Tensor:
    """cls / positions / pre-LN (OpenAI's only) -> int8 transformer ->
    post-LN / projection."""
    v = vq.visual
    cfg = v.cfg
    cls = v.class_embedding.to(dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + v.positional_embedding.to(dtype)
    if v.ln_pre is not None:
        x = layer_norm(v.ln_pre, x)
    act_kind = "gelu" if cfg.kind == "slip_vit" else "quick_gelu"
    x = transformer_q(vq.resblocks, x, cfg.heads, act_kind=act_kind, fused=fused)
    x = layer_norm(v.ln_post, x[:, 0, :])
    return x @ v.proj.to(dtype)


def encode_image_vit_q_p8(vq: QuantVisual, patches_u8: torch.Tensor, *,
                          dtype=torch.bfloat16,
                          fused: Optional[bool] = None) -> torch.Tensor:
    """Int8 ViT forward from patch-contiguous uint8 staging: the exact stem
    with the normalize folded into the weights."""
    x = patch_embed_q_p8(patches_u8, vq.conv1_folded, vq.conv1_bias_folded,
                         out_dtype=dtype)
    return _vit_q_trunk(vq, x, dtype, fused)


def encode_image_vit_q(vq: QuantVisual, images: torch.Tensor, *,
                       dtype=torch.bfloat16,
                       fused: Optional[bool] = None) -> torch.Tensor:
    """Int8 ViT forward from normalized [B, H, W, 3] images."""
    v = vq.visual
    x = patch_embed_q(images, v.cfg.patch_size, vq.conv1, v.conv1.bias,
                      out_dtype=dtype)
    return _vit_q_trunk(vq, x, dtype, fused)


def encode_text_q(tq: QuantText, text: torch.Tensor, *, dtype=torch.bfloat16,
                  fused: Optional[bool] = None) -> torch.Tensor:
    """Int8 text forward: [B, 77] ids -> [B, embed_dim]; only the resblock
    matmuls run int8."""
    t = tq.text
    x = add_positional(t, embed_tokens(t, text, dtype))
    x = transformer_q(tq.resblocks, x, t.cfg.heads, causal=True, fused=fused)
    return project_eot(t, layer_norm(t.ln_final, x), text)


def encode_text_q_debias(tq: QuantText, debias_tokens: torch.Tensor,
                         text: torch.Tensor, debias_cfg, *,
                         dtype=torch.bfloat16,
                         fused: Optional[bool] = None) -> torch.Tensor:
    """Debiased int8 text forward: prompts injected into the embedded
    sequence in floating point before the int8 tower, pooled at the
    shifted, clamped EOT."""
    t = tq.text
    x = add_positional(t, embed_tokens(t, text, dtype))
    x = inject_prompts(x, debias_tokens, text, debias_cfg.debias_pos)
    x = transformer_q(tq.resblocks, x, t.cfg.heads, causal=True, fused=fused)
    x = layer_norm(t.ln_final, x)
    idx = debias_eot_index(text, debias_tokens.shape[0], x.shape[1])
    return pool_and_project(t, x, idx)


# ---------------------------------------------------------------------------
# The bundle and the precision ladder
# ---------------------------------------------------------------------------


class QuantizedCLIP(nn.Module):
    """A CLIP or DebiasCLIP bundle with an int8 image tower, and with an int8
    text tower too when ``quantize_text``.  The int8 weights and scales are
    buffers on the base model's device; the float parameters are the base's.
    Text runs through the float base unless ``quantize_text``."""

    def __init__(self, base: nn.Module, quantize_text: bool = False):
        super().__init__()
        clip = base.clip if isinstance(base, DebiasCLIP) else base
        cfg = getattr(base, "clip_cfg", None) or getattr(base, "cfg", None)
        kind = getattr(getattr(cfg, "vision", None), "kind", None)
        if kind not in VIT_KINDS or not isinstance(clip, CLIP):
            raise NotImplementedError(
                f"the int8 rung runs CLIP / DebiasCLIP bundles with OpenAI ViT "
                f"towers or SLIP's, not vision kind {kind!r} ({type(base).__name__}); "
                f"{ROADMAP_OTHER_TOWERS}")
        self.base = base
        self.cfg = cfg
        self.visual_q = QuantVisual(clip.visual)
        self.text_q = QuantText(clip.text) if quantize_text else None

    @property
    def logit_scale(self) -> torch.Tensor:
        return self.base.logit_scale

    def encode_image(self, images: torch.Tensor, dtype=None,
                     fused: Optional[bool] = None) -> torch.Tensor:
        dtype = dtype or torch.bfloat16
        vis = self.cfg.vision
        if is_patch_staging(images, vis):
            return encode_image_vit_q_p8(self.visual_q, images, dtype=dtype,
                                         fused=fused)
        if images.dim() == 3:
            # any other 3-D input (one HWC image, a float lookalike of the
            # staging) would run through either stem as silent garbage
            raise ValueError(
                f"3-D image input must be the uint8 patch-contiguous staging "
                f"[B, {(vis.image_size // vis.patch_size) ** 2}, "
                f"{vis.patch_size ** 2 * 3}] (got {tuple(images.shape)} "
                f"{images.dtype}); batch single images to [1, H, W, 3]")
        return encode_image_vit_q(self.visual_q, images, dtype=dtype, fused=fused)

    def encode_text(self, text: torch.Tensor, dtype=None,
                    fused: Optional[bool] = None) -> torch.Tensor:
        if self.text_q is None:
            return self.base.encode_text(text, dtype=dtype or torch.float32,
                                         fused=fused)
        kw = {"dtype": dtype or torch.bfloat16, "fused": fused}
        if isinstance(self.base, DebiasCLIP):
            return encode_text_q_debias(self.text_q, self.base.debias_tokens,
                                        text, self.base.debias_cfg, **kw)
        return encode_text_q(self.text_q, text, **kw)


def resolve_compute(model, dtype: str):
    """A user-facing precision string -> ``(model, activation torch dtype)``,
    the one precision-ladder policy of the port: "int8" / "int8-text" wrap
    the bundle in QuantizedCLIP once (idempotently; text int8 too under
    "int8-text") and run bfloat16 activations between the int8 blocks;
    "bfloat16" / "float32" leave it as is.  "auto" picks the fastest
    measured rung per tower family in the JAX package; the port has no H100
    measurements of every rung yet, so it raises."""
    if dtype == "auto":
        raise NotImplementedError(f"dtype='auto' is not ported yet: {ROADMAP_AUTO}")
    if dtype in INT8_RUNGS:
        if not isinstance(model, QuantizedCLIP):
            model = QuantizedCLIP(model, quantize_text=dtype == "int8-text")
        return model, torch.bfloat16
    if dtype in DTYPES:
        return model, DTYPES[dtype]
    raise ValueError(f"unknown dtype {dtype!r}: expected one of "
                     f"{sorted(DTYPES) + list(INT8_RUNGS)}")
