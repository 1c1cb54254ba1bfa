"""ModifiedResNet image tower (OpenAI CLIP RN50 / RN101 / RN50x4) as
``nn.Module``s.

Counterpart of ``debias_vision_lang_tpu/models/resnet.py``: a 3-conv stem
(each conv + BN + ReLU) and a 2x2 average pool, four stages of bottlenecks
with anti-aliased downsampling (an average pool before every strided 1x1
conv), and an attention-pool head in place of global average pooling.  The
tower runs no kernel of the port, as the JAX one runs none: convolutions
are ``F.conv2d`` (cuDNN on the card), BatchNorm is the inference-mode
affine of the running statistics (the encoders are frozen), the pool is
plain tensor code.

Layout: the public functions take NHWC ``[B, H, W, 3]``, as the JAX
package's; parameters keep its tree (conv kernels HWIO, BatchNorm
``scale`` / ``bias`` / ``mean`` / ``var``, pool projections ``[in, out]``),
so ``models/convert.py`` only renames.  ``conv`` hands cuDNN an NHWC
activation as the NCHW view it already is in memory (``channels_last``, no
copy) and each kernel as an OIHW ``channels_last`` copy made once per
parameter version and dtype.  The float32 rung runs its convolutions with
cuDNN's TF32 off (``tf32_off``), whatever the process set: the flag is
True by default in PyTorch, and TF32 keeps about three decimal digits.

Rounding points, as the JAX tower: a bfloat16 conv accumulates in float32
and rounds once; ``batch_norm`` computes its scale and bias in float32 and
rounds both to the activation dtype before ``x * scale + bias``; the pool's
projections round to the activation dtype and add the bias there, its
scores, softmax and ``probs @ v`` run in float32, then round.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..core.config import VisionConfig

_BN_EPS = 1e-5
EXPANSION = 4


def _zeros(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


class Conv(nn.Module):
    """A bias-free conv kernel ``[kh, kw, c_in, c_out]`` (HWIO)."""

    def __init__(self, kh: int, kw: int, c_in: int, c_out: int):
        super().__init__()
        self.kernel = _zeros(kh, kw, c_in, c_out)


class BatchNorm(nn.Module):
    """Inference BatchNorm: affine ``scale`` / ``bias`` and the running
    ``mean`` / ``var``, all parameters of the tree (frozen as "other")."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = _zeros(c)
        self.mean = _zeros(c)
        self.var = nn.Parameter(torch.ones(c))


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = _zeros(d_in, d_out)
        self.bias = _zeros(d_out)


class Downsample(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = Conv(1, 1, c_in, c_out)
        self.bn = BatchNorm(c_out)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride  # static structure, as in the JAX tree
        self.conv1, self.bn1 = Conv(1, 1, c_in, planes), BatchNorm(planes)
        self.conv2, self.bn2 = Conv(3, 3, planes, planes), BatchNorm(planes)
        self.conv3 = Conv(1, 1, planes, planes * EXPANSION)
        self.bn3 = BatchNorm(planes * EXPANSION)
        self.downsample = (Downsample(c_in, planes * EXPANSION)
                           if stride > 1 or c_in != planes * EXPANSION else None)


class AttentionPool(nn.Module):
    def __init__(self, spacial_dim: int, embed_dim: int, out_dim: int):
        super().__init__()
        self.positional_embedding = _zeros(spacial_dim * spacial_dim + 1, embed_dim)
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, out_dim)


class ModifiedResNet(nn.Module):
    """CLIP's ModifiedResNet: ``cfg.width`` is the stem width (64 for RN50 /
    RN101, 80 for RN50x4), ``cfg.layers`` the blocks per stage, ``cfg.heads``
    the attention pool's heads."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        width = cfg.width
        self.conv1, self.bn1 = Conv(3, 3, 3, width // 2), BatchNorm(width // 2)
        self.conv2, self.bn2 = Conv(3, 3, width // 2, width // 2), BatchNorm(width // 2)
        self.conv3, self.bn3 = Conv(3, 3, width // 2, width), BatchNorm(width)
        c_in = width
        for stage_i, blocks in enumerate(cfg.layers):
            planes = width * 2 ** stage_i
            stage = nn.ModuleList()
            for bi in range(blocks):  # stride 2 opens stages 2-4
                stage.append(Bottleneck(c_in, planes, 2 if stage_i > 0 and bi == 0 else 1))
                c_in = planes * EXPANSION
            setattr(self, f"layer{stage_i + 1}", stage)
        self.attnpool = AttentionPool(cfg.image_size // 32, width * 32, cfg.embed_dim)

    def stages(self):
        return [getattr(self, f"layer{i}") for i in range(1, 5)]

    def forward(self, images: torch.Tensor, dtype=None,
                fused: Optional[bool] = None, use_pallas: Optional[bool] = None,
                remat: bool = False) -> torch.Tensor:
        """``fused``, ``use_pallas`` and ``remat`` are accepted for a uniform
        caller and ignored, as in the JAX tower (no kernel runs here)."""
        del fused, use_pallas, remat
        return encode_image_resnet(self, images, dtype=dtype or torch.float32)


@torch.no_grad()
def init_modified_resnet_params(v: ModifiedResNet, generator: torch.Generator) -> None:
    """The JAX package's init in place: conv kernels N(0, 2 / fan_in), every
    BatchNorm at identity but each bottleneck's bn3 scale at zero (CLIP's
    zero-init of the residual branch), the pool's embedding and kernels
    N(0, 1 / embed_dim), its biases zero.  Numbers differ from
    jax.random's for the same seed."""

    def nrm(p: nn.Parameter, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for mod in v.modules():
        if isinstance(mod, Conv):
            kh, kw, c_in, _ = mod.kernel.shape
            nrm(mod.kernel, math.sqrt(2.0 / (kh * kw * c_in)))
    for stage in v.stages():
        for blk in stage:
            blk.bn3.scale.zero_()
    ap = v.attnpool
    std = ap.positional_embedding.shape[1] ** -0.5
    nrm(ap.positional_embedding, std)
    for lin in (ap.q_proj, ap.k_proj, ap.v_proj, ap.c_proj):
        nrm(lin.kernel, std)


# ---------------------------------------------------------------------------
# Layers on NHWC tensors
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def tf32_off():
    """cuDNN's TF32 off for the block, the old setting restored after."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


# OIHW channels_last copies of the HWIO kernels, per parameter and dtype,
# rebuilt whenever the parameter's storage or version counter moves
_OIHW = WeakIdKeyDictionary()


def _oihw(kernel: torch.Tensor, dtype) -> torch.Tensor:
    if torch.is_grad_enabled() and kernel.requires_grad:
        return kernel.to(dtype).permute(3, 2, 0, 1)
    key = (kernel.data_ptr(), kernel._version)
    copies = _OIHW.setdefault(kernel, {})
    hit = copies.get(dtype)
    if hit is None or hit[0] != key:
        t = kernel.detach().to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        hit = copies[dtype] = (key, t)
    return hit[1]


def conv(p: Conv, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC conv with the HWIO kernel in x's dtype; float32 with TF32 off."""
    w = _oihw(p.kernel, x.dtype)
    scope = tf32_off() if x.dtype == torch.float32 else contextlib.nullcontext()
    with scope:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def batch_norm(p: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Inference BN, scale and bias in float32 rounded to x's dtype."""
    inv = torch.rsqrt(p.var.float() + _BN_EPS)
    scale = (p.scale.float() * inv).to(x.dtype)
    bias = (p.bias.float() - p.mean.float() * p.scale.float() * inv).to(x.dtype)
    return x * scale + bias


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average pool of an NHWC tensor, stride k: the window's sum in
    x's dtype, then / k^2, as the JAX tower's reduce_window.  The sum runs
    in the order XLA's CPU backend takes (each row's pair, then the rows'
    sums, in float32; one element after another in bfloat16), so the int8
    tower's per-image quantization sees the JAX tower's values bit for
    bit."""
    rows = []
    for i in range(k):
        row = [x[:, i::k, j::k] for j in range(k)]
        rows.append(row if x.dtype != torch.float32 else [sum(row[1:], row[0])])
    parts = [t for row in rows for t in row]
    return sum(parts[1:], parts[0]) / (k * k)


def bottleneck(p: Bottleneck, x: torch.Tensor) -> torch.Tensor:
    out = F.relu(batch_norm(p.bn1, conv(p.conv1, x)))
    out = F.relu(batch_norm(p.bn2, conv(p.conv2, out, padding=1)))
    if p.stride > 1:  # anti-aliased downsampling: pool, then 1x1 conv
        out = avg_pool(out, p.stride)
    out = batch_norm(p.bn3, conv(p.conv3, out))
    identity = x
    if p.downsample is not None:
        if p.stride > 1:
            identity = avg_pool(identity, p.stride)
        identity = batch_norm(p.downsample.bn, conv(p.downsample.conv, identity))
    return F.relu(out + identity)


def pool_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """The pool's single-query attention: q [B, 1, C], k / v [B, T, C] ->
    [B, C]; scores, softmax and probs @ v in float32, rounded to v's
    dtype."""
    b, t, c = k.shape
    hd = c // heads
    q = q.reshape(b, 1, heads, hd).transpose(1, 2)
    k = k.reshape(b, t, heads, hd).transpose(1, 2)
    v = v.reshape(b, t, heads, hd).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    o = torch.matmul(probs, v.float()).to(v.dtype)
    return o.transpose(1, 2).reshape(b, c)


def pool_tokens(positional_embedding: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, HW + 1, C]: the mean token first, positions added."""
    b, h, w, c = x.shape
    x = x.reshape(b, h * w, c)
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
    return x + positional_embedding.to(x.dtype)[None]


def attn_pool(p: AttentionPool, x: torch.Tensor, heads: int) -> torch.Tensor:
    """CLIP's AttentionPool2d: the mean token is the only query over
    [mean; HW].  x: [B, H, W, C] -> [B, out_dim]."""
    x = pool_tokens(p.positional_embedding, x)

    def proj(lin: Linear, t):
        return torch.matmul(t, lin.kernel.to(t.dtype)) + lin.bias.to(t.dtype)

    o = pool_attention(proj(p.q_proj, x[:, :1]), proj(p.k_proj, x),
                       proj(p.v_proj, x), heads)
    return proj(p.c_proj, o)


def check_nhwc(images: torch.Tensor) -> None:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"a ModifiedResNet takes NHWC images [B, H, W, 3], got "
                         f"{tuple(images.shape)} {images.dtype}")


def encode_image_resnet(v: ModifiedResNet, images: torch.Tensor, *,
                        dtype=torch.float32) -> torch.Tensor:
    """[B, H, W, 3] normalized NHWC images -> [B, embed_dim]."""
    check_nhwc(images)
    x = images.to(dtype)
    x = F.relu(batch_norm(v.bn1, conv(v.conv1, x, stride=2, padding=1)))
    x = F.relu(batch_norm(v.bn2, conv(v.conv2, x, padding=1)))
    x = F.relu(batch_norm(v.bn3, conv(v.conv3, x, padding=1)))
    x = avg_pool(x, 2)
    for stage in v.stages():
        for blk in stage:
            x = bottleneck(blk, x)
    return attn_pool(v.attnpool, x, v.cfg.heads)
