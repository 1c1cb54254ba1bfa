"""Int8 inference for the ViT families (OpenAI CLIP and SLIP) and the
Frozen-in-Time video towers: weight quantization, the plain int8 layers,
the int8 stems and towers, and ``QuantizedCLIP``, which also takes a
ModifiedResNet (its int8 tower is ``ops/quant_resnet.py``).

Counterpart of ``debias_vision_lang_tpu/ops/quant.py`` ("vit",
"slip_vit", "video_vit" and "resnet" towers):
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

The video towers (``quantize_video_visual``): the joint one runs
``transformer_q`` over its 785 tokens -- on a CUDA tensor at bfloat16 that
is K3 + K4, K3's attention core on its long route past 320 keys; the
divided one runs each block's temporal attention (S = T = 4) on the plain
int8 path (``attn_residual_q``), as the JAX package does, and the spatial
attention + MLP pair as one int8 block on the [B*T, N, D] layout: the fused
blocks (K3 + K4 at S = 196) on bfloat16 activations, the plain int8 layers
at float32.

A tower placed tensor-parallel (``parallel/mesh.shard_quantized_clip``:
its ``resblocks`` a ``parallel/tensor.TensorParallelQBlocks``) runs the
same routes split over the model slots, bit-equal to the unsharded tower;
the divided tower's temporal attention and every stem stay replicated.

The precision ladder (``resolve_rung``, ``resolve_compute``,
``hint_implicit_fp32``) is the JAX package's policy: "auto" is int8 for the
ViT families and bfloat16 for a ModifiedResNet, so the same bundle runs
the same rung in both packages.

Not ported: the TPU's hybrid long-sequence branch (XLA attention + the
F-split MLP kernel, there only because the TPU compiler could not build
the attention kernel at S = 785) and its VMEM gates, and the u8 stem (off
every default path).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch import nn

from ..models.clip import (CLIP, TOWER_KINDS, _use_fused_blocks, add_positional,
                           embed_tokens, fold_preprocess_into_patch, is_patch_staging,
                           pool_and_project, project_eot, unknown_tower)
from ..models.debias import DebiasCLIP, debias_eot_index, inject_prompts
from ..models.layers import attention_bshd, causal_mask, gelu, layer_norm, quick_gelu
from .fused_block_q import (dot_q, fused_resblock_q, fused_transformer_q, int_mm,
                            quant_rows, true_div)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
INT8_RUNGS = ("int8", "int8-text")
# the speed of the rung "auto" picks against the float32 tower, images/s,
# over the registry's ViT, SLIP and ResNet archs at B=256 on an NVIDIA H100
# (benchmarks_torch/rung_phase.py; PERF.md section 5)
AUTO_SPEEDUP = "3.6-11.0x"


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
    additive text mask there); split over the model slots for a
    ``TensorParallelQBlocks`` (blocks with a ``run`` method run themselves)."""
    if hasattr(blocks, "run"):
        route = "fused" if _use_fused_blocks(x.dtype, fused=fused) else "plain"
        return blocks.run(x, route=route, act_kind=act_kind, causal=causal)
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
# Frozen-in-Time video towers (models/frozen_in_time.py)
# ---------------------------------------------------------------------------


class QuantTemporalBlock(nn.Module):
    """Layer ``i`` of a video tower's stacked temporal attention in the shape
    ``attn_residual_q`` takes: ``ln_1`` (the temporal LayerNorm, ln_t),
    int8 ``wqkv`` / ``wo``, and the float biases, read from the float tower
    at call time (shared, not copied)."""

    def __init__(self, temporal_attn, i: int):
        super().__init__()
        self.ta, self.i = temporal_attn, i
        self.wqkv = QWeight(temporal_attn.attn.wqkv[i])
        self.wo = QWeight(temporal_attn.attn.wo[i])

    @property
    def ln_1(self):
        return self.ta.layer(self.i)[0]

    @property
    def bqkv(self):
        return self.ta.attn.bqkv[self.i]

    @property
    def bo(self):
        return self.ta.attn.bo[self.i]


class QuantVideoVisual(nn.Module):
    """The int8 weights of a ``VideoVisionTransformer`` (the JAX package's
    ``quantize_video_visual``): the patch kernel, the residual blocks and
    each layer's temporal QKV / out projections.  Embeddings, LayerNorms,
    biases and the projection stay the float tower's (``visual``).  Video
    frames arrive preprocessed, so no normalize is folded into a stem."""

    def __init__(self, visual):
        super().__init__()
        self.visual = visual
        self.conv1 = QWeight(visual.conv1.kernel)
        self.resblocks = quantize_resblocks(visual.resblocks)
        self.temporal = nn.ModuleList(QuantTemporalBlock(visual.temporal_attn, i)
                                      for i in range(len(visual.resblocks)))


def quantize_video_visual(visual) -> QuantVideoVisual:
    return QuantVideoVisual(visual)


def _video_patch_embed_q(vq: QuantVideoVisual, dtype):
    """The int8 stem for ``frozen_in_time._video_tokens``: dynamic per-patch
    int8, the conv bias added after the dequantize."""
    v = vq.visual

    def pe(frames):
        return patch_embed_q(frames, v.cfg.patch_size, vq.conv1, v.conv1.bias,
                             out_dtype=dtype)

    return pe


def encode_video_q(vq: QuantVideoVisual, videos: torch.Tensor, *, dtype=torch.bfloat16,
                   fused: Optional[bool] = None) -> torch.Tensor:
    """Int8 joint video forward: [B, T, H, W, 3] (or a 4-D batch of 1-frame
    videos) -> [B, embed_dim]; one attention over [CLS] + T*N tokens in
    ``transformer_q`` (K3 + K4 on a CUDA tensor at bfloat16, the core on
    its long route at S = 785)."""
    from ..models import frozen_in_time as fit

    v = vq.visual
    x, _, _, _ = fit._video_tokens(v, videos, dtype, _video_patch_embed_q(vq, dtype))
    x = fit._class_and_ln_pre(v, x, dtype)
    x = transformer_q(vq.resblocks, x, v.cfg.heads, act_kind="gelu", fused=fused)
    x = layer_norm(v.ln_post, x[:, 0, :])
    return fit._project(x, v.proj, x.dtype)


def encode_video_divided_q(vq: QuantVideoVisual, videos: torch.Tensor, *,
                           dtype=torch.bfloat16,
                           fused: Optional[bool] = None) -> torch.Tensor:
    """Int8 divided video forward: per block, the temporal attention over T
    at each location on the plain int8 path (S = T: the attention core
    stays floating point, as in the JAX package), then the spatial
    attention + MLP as one int8 residual block on the [B*T, N, D] layout
    (``fused_resblock_q`` on bfloat16 activations or ``fused=True``,
    ``resblock_q`` otherwise); mean-pooled."""
    from ..models import frozen_in_time as fit

    v = vq.visual
    w, heads = v.cfg.width, v.cfg.heads
    x, b, t, n = fit._video_tokens(v, videos, dtype, _video_patch_embed_q(vq, dtype))
    x = layer_norm(v.ln_pre, x)
    use_fused = _use_fused_blocks(x.dtype, fused=fused)
    for i, (blk, tblk) in enumerate(zip(vq.resblocks, vq.temporal)):
        xt = attn_residual_q(tblk, x.transpose(1, 2).reshape(b * n, t, w), heads)
        xs = xt.reshape(b, n, t, w).transpose(1, 2).reshape(b * t, n, w)
        if hasattr(vq.resblocks, "run"):  # split blocks run their own blocks
            xs = vq.resblocks.block(i, xs, route="fused" if use_fused else "plain",
                                    act_kind="gelu")
        elif use_fused:
            xs = fused_resblock_q(blk, xs, heads, act_kind="gelu")
        else:
            xs = resblock_q(blk, xs, heads, act_kind="gelu")
        x = xs.reshape(b, t, n, w)
    return fit._mean_pool_project(v, x, x.dtype)


# ---------------------------------------------------------------------------
# The bundle and the precision ladder
# ---------------------------------------------------------------------------


class QuantizedCLIP(nn.Module):
    """A CLIP or DebiasCLIP bundle with an int8 image tower, and with an int8
    text tower too when ``quantize_text``.  The int8 weights and scales are
    buffers on the base model's device; the float parameters are the base's.
    Text runs through the float base unless ``quantize_text``.  A
    ModifiedResNet's int8 tower is ``ops/quant_resnet.py``'s.  A video
    tower runs the formulation of the ``FrozenInTime`` under the wrapper
    (``frozen_in_time.formulation``: its ``attention``, else the config's
    ``video_attention``), and takes images as 1-frame videos."""

    def __init__(self, base: nn.Module, quantize_text: bool = False):
        super().__init__()
        clip = base.clip if isinstance(base, DebiasCLIP) else base
        cfg = getattr(base, "clip_cfg", None) or getattr(base, "cfg", None)
        kind = getattr(getattr(cfg, "vision", None), "kind", None)
        if kind not in TOWER_KINDS or not isinstance(clip, CLIP):
            raise NotImplementedError(
                f"the int8 rung runs CLIP / DebiasCLIP bundles with OpenAI ViT "
                f"towers, SLIP's, Frozen-in-Time's or ModifiedResNets, not vision "
                f"kind {kind!r} ({type(base).__name__}); {unknown_tower(kind)}")
        self.base = base
        self.cfg = cfg
        if kind == "resnet":
            from .quant_resnet import quantize_resnet_visual

            self.visual_q = quantize_resnet_visual(clip.visual)
        elif kind == "video_vit":
            self.visual_q = quantize_video_visual(clip.visual)
        else:
            self.visual_q = QuantVisual(clip.visual)
        self.text_q = QuantText(clip.text) if quantize_text else None

    @property
    def logit_scale(self) -> torch.Tensor:
        return self.base.logit_scale

    def encode_image(self, images: torch.Tensor, dtype=None,
                     fused: Optional[bool] = None) -> torch.Tensor:
        dtype = dtype or torch.bfloat16
        vis = self.cfg.vision
        if vis.kind == "resnet":  # before the staging test: patch_size is 32
            from .quant_resnet import encode_image_resnet_q

            return encode_image_resnet_q(self.visual_q, images, dtype=dtype)
        if vis.kind == "video_vit":
            from ..models.frozen_in_time import formulation

            fn = encode_video_divided_q if formulation(self) == "divided" else encode_video_q
            return fn(self.visual_q, images, dtype=dtype, fused=fused)
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

    encode_video = encode_image

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


def _vision_kind(model) -> Optional[str]:
    """VisionConfig.kind of a bundle (CLIP, FrozenInTime and QuantizedCLIP
    carry ``cfg``, DebiasCLIP ``clip_cfg``), None for a custom ClipLike."""
    cfg = getattr(model, "cfg", None) or getattr(model, "clip_cfg", None)
    return getattr(getattr(cfg, "vision", None), "kind", None)


def resolve_rung(model, dtype: str) -> str:
    """The rung a user-facing dtype string resolves to for this bundle, with
    no wrapping: "auto" gives "int8" for the ViT towers (OpenAI, SLIP,
    Frozen-in-Time) and "bfloat16" for a ModifiedResNet or a bundle whose
    tower kind cannot be found; every other string passes through.  The
    JAX package's policy, kept so that "auto" runs the same rung, and gives
    the same embeddings, in both packages; the card's own rung ratios are
    in PERF.md section 5."""
    if dtype != "auto":
        return dtype
    return "bfloat16" if _vision_kind(model) in (None, "resnet") else "int8"


def _device_type(model) -> Optional[str]:
    try:
        return next(model.parameters()).device.type
    except (AttributeError, StopIteration, TypeError):
        return None


def hint_implicit_fp32(entry: str, model) -> None:
    """A one-line hint when an eval entry point runs at its float32 default
    (the caller passed no dtype) on a model that lives on a card: the
    default stays float32 for reference parity, and dtype='auto' is the way
    to the faster rungs.  An explicit "float32" never reaches here."""
    if _device_type(model) != "cuda":
        return
    warnings.warn(
        f"{entry}: dtype defaulted to float32 (reference parity). On this card, "
        f"dtype='auto' picks the fastest measured rung per model family "
        f"({AUTO_SPEEDUP} the float32 tower's images/s, rank-stable; PERF.md "
        f"section 5).", UserWarning, stacklevel=3)


def resolve_compute(model, dtype: str):
    """A user-facing precision string -> ``(model, activation torch dtype)``,
    the one precision-ladder policy of the port: "int8" / "int8-text" wrap
    the bundle in QuantizedCLIP once (idempotently; text int8 too under
    "int8-text") and run bfloat16 activations between the int8 blocks;
    "bfloat16" / "float32" leave it as is; "auto" takes the rung
    ``resolve_rung`` gives.  An int8 rung on a ModifiedResNet runs, and
    warns when it wraps the bundle: there it buys 4x smaller weights, not
    throughput (PERF.md has the card's ratio)."""
    dtype = resolve_rung(model, dtype)
    if dtype in INT8_RUNGS:
        if not isinstance(model, QuantizedCLIP):
            model = QuantizedCLIP(model, quantize_text=dtype == "int8-text")
            if model.cfg.vision.kind == "resnet":
                warnings.warn(
                    f"dtype={dtype!r} on a ModifiedResNet tower: int8 buys 4x "
                    f"smaller weights, not throughput; its speed against "
                    f"dtype='bfloat16' is measured in PERF.md. Use "
                    f"dtype='bfloat16' for speed, or dtype='auto' to pick the "
                    f"fastest rung per family.", UserWarning, stacklevel=2)
        return model, torch.bfloat16
    if dtype in DTYPES:
        return model, DTYPES[dtype]
    raise ValueError(f"unknown dtype {dtype!r}: expected one of "
                     f"{sorted(DTYPES) + list(INT8_RUNGS)} or 'auto'")
