"""Int8 inference for the ModifiedResNet image tower (CLIP RN50 / RN101 /
RN50x4).

Counterpart of ``debias_vision_lang_tpu/ops/quant_resnet.py``; as there, no
kernel of the port runs here (the JAX package's int8 convolutions are XLA's,
outside any Pallas kernel):

  * BN folding: the inference BatchNorm is a per-channel affine, folded
    into the conv before it, ``w' = w * gamma / sqrt(var + eps)`` per output
    channel plus a float32 bias; per-output-channel quantization of ``w'``
    then absorbs the folded scale.
  * 1x1 convs (each bottleneck's conv1 / conv3 / downsample) and the
    attention pool's projections are per-row dynamic int8 matmuls (a pixel
    is a row): ``ops/quant.py::int8_matmul``.
  * 3x3 convs (the stem and each bottleneck's conv2) quantize the
    activations with one scale per image over (H, W, C), then run the exact
    int32 product as an im2col GEMM: the padded, strided int8 windows in
    (kh, kw, C) order, matching the HWIO kernel reshaped to ``[K, C_out]``,
    through ``ops/fused_block_q.py::int_mm`` (``torch._int_mm``; cuBLAS's
    int8 GEMM on the card).  cuBLAS takes K in multiples of 8, so K is
    zero-padded to one (the stem's first conv has K = 3*3*3 = 27), which is
    exact; so are the zero columns that pad the output channels to a
    multiple of 16 (cuBLAS refuses RN50x4's 40 at the stem's 5.3 M rows).
    The dequantize is ``acc * s_x * w_scale + bias`` in float32.
  * Residual adds, ReLUs, average pools and the pool's attention core stay
    floating point.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..models.resnet import (_BN_EPS, AttentionPool, BatchNorm, Conv, ModifiedResNet,
                             avg_pool, check_nhwc, pool_attention, pool_tokens)
from .fused_block_q import int_mm, true_div
from .quant import QWeight, int8_matmul

K_ALIGN = 8  # cuBLAS's int8 GEMM takes K in multiples of 8
# and, at millions of rows and a short K, no N that is not a multiple of 16:
# RN50x4's first stem conv (N = 40, K = 27 -> 32) is refused with
# CUBLAS_STATUS_NOT_SUPPORTED on an H100 (benchmarks_torch/int_mm_shapes.py)
N_ALIGN = 16


def fold_bn(conv_p: Conv, bn_p: BatchNorm):
    """(conv, inference BN) -> (folded f32 kernel [kh, kw, ci, co], f32 bias)."""
    inv = torch.rsqrt(bn_p.var.detach().float() + _BN_EPS)
    s = bn_p.scale.detach().float() * inv
    w = conv_p.kernel.detach().float() * s
    b = bn_p.bias.detach().float() - bn_p.mean.detach().float() * s
    return w, b


def quantize_conv_weight(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8: [kh, kw, ci, co] -> {"q": int8 of
    the same shape, "scale": f32 [co]}, scale = max(amax over (kh, kw, ci) /
    127, 1e-8), q = clip(round_half_even(w / scale), -127, 127)."""
    w = w.detach().float()
    scale = torch.clamp(true_div(w.abs().amax(dim=(0, 1, 2)), 127.0), min=1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


class QConv(nn.Module):
    """A folded kxk conv, quantized: ``q`` / ``scale`` as
    ``quantize_conv_weight`` gives them, the f32 ``bias``, and the im2col
    GEMM's operands made once: ``q2`` [K8, N16] and its transpose ``q2t``
    [N16, K8] (the K-contiguous copy cuBLAS reads), K = kh*kw*ci and N = co
    zero-padded to multiples of ``K_ALIGN`` and ``N_ALIGN``."""

    def __init__(self, w: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        qw = quantize_conv_weight(w)
        kh, kw, ci, co = qw["q"].shape
        k = kh * kw * ci
        q2 = F.pad(qw["q"].reshape(k, co), (0, -co % N_ALIGN, 0, -k % K_ALIGN))
        self.register_buffer("q", qw["q"])
        self.register_buffer("scale", qw["scale"])
        self.register_buffer("bias", bias)
        self.register_buffer("q2", q2)
        self.register_buffer("q2t", q2.t().contiguous())


def quant_images(x: torch.Tensor):
    """Dynamic int8 with one scale per image: f32 [B, H, W, C] -> (int8 of
    the same shape, f32 scale [B, 1, 1, 1])."""
    amax = x.abs().amax(dim=(1, 2, 3), keepdim=True)
    s_x = torch.clamp(true_div(amax, 127.0), min=1e-8)
    return torch.clamp(torch.round(x / s_x), -127, 127).to(torch.int8), s_x


def im2col(xq: torch.Tensor, kh: int, kw: int, stride: int, padding: int,
           k_pad: int = 0) -> torch.Tensor:
    """[B, H, W, C] -> [B * Ho * Wo, kh * kw * C + k_pad], each row one
    output pixel's zero-padded window in (kh, kw, C) order."""
    x = F.pad(xq, (0, 0, padding, padding, padding, padding))
    b, h, w, c = x.shape
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    sb, sh, sw, sc = x.stride()
    win = x.as_strided((b, ho, wo, kh, kw, c),
                       (sb, sh * stride, sw * stride, sh, sw, sc))
    cols = win.reshape(b * ho * wo, kh * kw * c)
    return F.pad(cols, (0, k_pad)) if k_pad else cols


def int8_conv(x: torch.Tensor, wq: QConv, stride: int = 1,
              padding: int = 0) -> torch.Tensor:
    """Dynamic-activation int8 conv of NHWC ``x``: per-image activation
    scale, exact int32 im2col product, dequantized (acc * s_x) * w_scale +
    bias in float32, then x's dtype."""
    xq, s_x = quant_images(x.float())
    kh, kw, _, co = wq.q.shape
    b, h, w, c = x.shape
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    cols = im2col(xq, kh, kw, stride, padding, wq.q2.shape[0] - kh * kw * c)
    acc = int_mm(cols, wq.q2, wq.q2t)[:, :co]
    out = acc.reshape(b, ho, wo, co).float() * s_x * wq.scale + wq.bias
    return out.to(x.dtype)


class Q1x1(nn.Module):
    """A folded 1x1 conv as an int8 matmul: ``w`` is ``QWeight`` of the
    kernel's [ci, co] (per-row pixel scales at run time), ``bias`` f32."""

    def __init__(self, w: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.w = QWeight(w[0, 0])
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, self.w, self.bias)


def _q1x1(conv_p: Conv, bn_p: BatchNorm) -> Q1x1:
    return Q1x1(*fold_bn(conv_p, bn_p))


class QBottleneck(nn.Module):
    def __init__(self, blk):
        super().__init__()
        self.stride = blk.stride
        self.conv1 = _q1x1(blk.conv1, blk.bn1)
        self.conv2 = QConv(*fold_bn(blk.conv2, blk.bn2))
        self.conv3 = _q1x1(blk.conv3, blk.bn3)
        self.downsample = (None if blk.downsample is None
                           else _q1x1(blk.downsample.conv, blk.downsample.bn))


class QAttentionPool(nn.Module):
    """The pool's four projections as ``QWeight``s; its positional embedding
    and biases are the float pool's parameters (shared, not copied)."""

    def __init__(self, ap: AttentionPool):
        super().__init__()
        self.positional_embedding = ap.positional_embedding
        for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
            lin = getattr(ap, name)
            setattr(self, name, QWeight(lin.kernel))
            setattr(self, f"{name}_bias", lin.bias)


class QuantResNet(nn.Module):
    """``quantize_resnet_visual``'s result: every conv + BN pair folded to
    one int8 conv or matmul with a float32 bias, the pool's projections
    quantized like a transformer's matmuls."""

    def __init__(self, visual: ModifiedResNet):
        super().__init__()
        self.cfg = visual.cfg
        for i in (1, 2, 3):  # the 3x3 stem convs
            setattr(self, f"conv{i}", QConv(*fold_bn(getattr(visual, f"conv{i}"),
                                                     getattr(visual, f"bn{i}"))))
        for i, stage in enumerate(visual.stages(), start=1):
            setattr(self, f"layer{i}", nn.ModuleList(QBottleneck(b) for b in stage))
        self.attnpool = QAttentionPool(visual.attnpool)

    def stages(self):
        return [getattr(self, f"layer{i}") for i in range(1, 5)]


@torch.no_grad()
def quantize_resnet_visual(visual: ModifiedResNet) -> QuantResNet:
    """Quantize a ModifiedResNet (``models/resnet.py``) for int8 inference."""
    return QuantResNet(visual)


def bottleneck_q(p: QBottleneck, x: torch.Tensor) -> torch.Tensor:
    """Int8 bottleneck, structured as ``models/resnet.py::bottleneck``."""
    out = F.relu(p.conv1(x))
    out = F.relu(int8_conv(out, p.conv2, padding=1))
    if p.stride > 1:
        out = avg_pool(out, p.stride)
    out = p.conv3(out)
    identity = x
    if p.downsample is not None:
        if p.stride > 1:
            identity = avg_pool(identity, p.stride)
        identity = p.downsample(identity)
    return F.relu(out + identity)


def attn_pool_q(p: QAttentionPool, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Int8 attention pool: the four projections int8, the single-query
    core in floating point (``models/resnet.py::attn_pool``)."""
    x = pool_tokens(p.positional_embedding, x)

    def proj(name, t):
        return int8_matmul(t, getattr(p, name), getattr(p, f"{name}_bias"))

    o = pool_attention(proj("q_proj", x[:, :1]), proj("k_proj", x),
                       proj("v_proj", x), heads)
    return proj("c_proj", o)


def encode_image_resnet_q(qv: QuantResNet, images: torch.Tensor, *,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Int8 ModifiedResNet forward: [B, H, W, 3] -> [B, embed_dim], the
    structure of ``models/resnet.py::encode_image_resnet``."""
    check_nhwc(images)
    x = images.to(dtype)
    x = F.relu(int8_conv(x, qv.conv1, stride=2, padding=1))
    x = F.relu(int8_conv(x, qv.conv2, padding=1))
    x = F.relu(int8_conv(x, qv.conv3, padding=1))
    x = avg_pool(x, 2)
    for stage in qv.stages():
        for blk in stage:
            x = bottleneck_q(blk, x)
    return attn_pool_q(qv.attnpool, x, qv.cfg.heads)
