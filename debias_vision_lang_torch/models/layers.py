"""Transformer building blocks: parameter modules in the JAX package's layout
and the plain (unfused) forward math on tensors.

Counterpart of ``debias_vision_lang_tpu/models/layers.py``.  Linear weights
are stored ``[in, out]`` (``wqkv`` is ``[D, 3D]`` = q | k | v), so the
weight bridge (``models/convert.py``) copies arrays without transposing.
Parameters are float32; ``dtype`` at the call selects the compute precision
(float32 is the parity rung, bfloat16 the speed rung).  At bfloat16 the
plain attention follows ``ops/attention.py::attention_bshd``: bf16 scores,
an f32-summed and bf16-rounded softmax denominator, f32-accumulated PV.
``use_pallas=True`` takes the heads-first branch through
``ops/attention.py::attention`` (the CUDA kernel ``attention_pallas`` on a
CUDA tensor); ``remat=True`` checkpoints each block
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does per layer.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.wqkv = nn.Parameter(torch.empty(d, 3 * d))
        self.bqkv = nn.Parameter(torch.zeros(3 * d))
        self.wo = nn.Parameter(torch.empty(d, d))
        self.bo = nn.Parameter(torch.zeros(d))


class MLP(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty(d, f))
        self.b1 = nn.Parameter(torch.zeros(f))
        self.w2 = nn.Parameter(torch.empty(f, d))
        self.b2 = nn.Parameter(torch.zeros(d))


class ResidualBlock(nn.Module):
    """Parameters of one pre-LN residual attention block."""

    def __init__(self, d: int):
        super().__init__()
        self.ln_1 = LayerNorm(d)
        self.attn = Attention(d)
        self.ln_2 = LayerNorm(d)
        self.mlp = MLP(d, 4 * d)


def make_resblocks(layers: int, width: int) -> nn.ModuleList:
    return nn.ModuleList(ResidualBlock(width) for _ in range(layers))


@torch.no_grad()
def init_resblocks(blocks: nn.ModuleList, generator: torch.Generator) -> None:
    """OpenAI CLIP's init, as ``init_resblocks`` in the JAX package: in-proj
    std w^-0.5, out-proj and MLP proj (w^-0.5)(2L)^-0.5, MLP fc (2w)^-0.5,
    LayerNorms at identity, biases zero."""
    layers = len(blocks)
    for blk in blocks:
        width = blk.ln_1.scale.shape[0]
        attn_std = width ** -0.5
        proj_std = attn_std * (2 * layers) ** -0.5
        fc_std = (2 * width) ** -0.5
        for p, std in ((blk.attn.wqkv, attn_std), (blk.attn.wo, proj_std),
                       (blk.mlp.w1, fc_std), (blk.mlp.w2, proj_std)):
            p.copy_(torch.randn(p.shape, generator=generator) * std)
        for ln in (blk.ln_1, blk.ln_2):
            ln.scale.fill_(1.0)
            ln.bias.zero_()
        for p in (blk.attn.bqkv, blk.attn.bo, blk.mlp.b1, blk.mlp.b2):
            p.zero_()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """QuickGELU: x * sigmoid(1.702 x) -- OpenAI CLIP's MLP activation."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU of timm-style towers (SLIP), as
    ``jax.nn.gelu(approximate=False)``: not the tanh form, and not the A&S
    polynomial the fused kernels evaluate."""
    return F.gelu(x, approximate="none")


def ln_f32(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 (two-pass variance), cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm(p: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return ln_f32(x, p.scale, p.bias)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype) + b.to(x.dtype)


def causal_mask(s: int, device=None) -> torch.Tensor:
    """CLIP's additive causal mask: -inf above the diagonal, [S, S] f32."""
    return torch.full((s, s), float("-inf"), device=device).triu(1)


def attention_bshd(q, k, v, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention in [B, S, H, hd] layout."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dtype == torch.bfloat16:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        if mask is not None:
            s = s + mask.to(s.dtype)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True, dtype=torch.float32).to(torch.bfloat16)
        return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask.float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attention_heads(qkv: torch.Tensor, heads: int,
                    mask: Optional[torch.Tensor] = None,
                    use_pallas: Optional[bool] = None) -> torch.Tensor:
    """The attention between the projections: packed qkv [B, S, 3D] (q | k |
    v, ``heads`` heads each) -> [B, S, D]; ``use_pallas`` takes K5."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (t.reshape(b, s, heads, d // heads) for t in qkv.split(d, -1))
    if use_pallas:
        from ..ops.attention import attention

        o = attention(*(t.transpose(1, 2) for t in (q, k, v)), mask,
                      use_pallas=True)
        return o.transpose(1, 2).reshape(b, s, d)
    return attention_bshd(q, k, v, mask).reshape(b, s, d)


def multi_head_attention(p: Attention, x: torch.Tensor, heads: int,
                         mask: Optional[torch.Tensor] = None,
                         use_pallas: Optional[bool] = None) -> torch.Tensor:
    o = attention_heads(linear(x, p.wqkv, p.bqkv), heads, mask, use_pallas)
    return linear(o, p.wo, p.bo)


def resblock(p: ResidualBlock, x: torch.Tensor, heads: int,
             mask: Optional[torch.Tensor] = None,
             act: Callable = quick_gelu,
             use_pallas: Optional[bool] = None) -> torch.Tensor:
    """One pre-LN residual attention block, plain math in x's dtype."""
    x = x + multi_head_attention(p.attn, layer_norm(p.ln_1, x), heads, mask,
                                 use_pallas=use_pallas)
    h = act(linear(layer_norm(p.ln_2, x), p.mlp.w1, p.mlp.b1))
    return x + linear(h, p.mlp.w2, p.mlp.b2)


def transformer(blocks: nn.ModuleList, x: torch.Tensor, heads: int,
                mask: Optional[torch.Tensor] = None,
                act: Callable = quick_gelu,
                use_pallas: Optional[bool] = None,
                remat: bool = False) -> torch.Tensor:
    for blk in blocks:
        if remat:
            x = checkpoint(resblock, blk, x, heads, mask, act, use_pallas,
                           use_reentrant=False)
        else:
            x = resblock(blk, x, heads, mask=mask, act=act,
                         use_pallas=use_pallas)
    return x
