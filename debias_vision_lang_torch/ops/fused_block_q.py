"""Int8 fused transformer-block entry points: a hand-written CUDA kernel for
each, and the plain PyTorch twin that specifies its math.

Counterpart of ``debias_vision_lang_tpu/ops/fused_block_q.py``:

  attention_block_q:  out = x + (deq(q(MHA(LN1(x))) @ Wo_q) + bo)
  mlp_block_q:        out = (x + b2) + deq(q(act(deq(q(LN2(x)) @ W1_q) + b1)) @ W2_q)

``q(.)`` is ``quant_rows``, the per-row dynamic int8 of the JAX package's
``_quant_rows``; weights are ``ops/quant.quantize_weight``'s, in the JAX
layout (q ``[in, out]`` int8, scale ``[1, out]`` f32); ``deq`` is
(int32 product * row scale) * channel scale.  The twins round where the TPU
kernels round: LN output, qkv and per-head attention outputs in the input
dtype, the MLP hidden kept f32 until it is quantized, residual adds in f32
with one rounding.  Their integer products are exact on any device
(``int_mm``).

Each wrapper takes the tensor's device as the route: a CPU tensor runs the
twin, a CUDA tensor launches the kernel (``csrc/fused_block_q.cu``) or
raises -- nothing falls back.  All four products run one s8 wgmma GEMM,
and the attention block's core is the bf16 blocks' wgmma core.  The GEMM
reads each weight transposed to ``[out, in]`` (K contiguous: 8-bit wgmma
takes K-major operands only), so a CUDA call takes those copies as ``*_qt``
(``ops/quant.QWeight`` makes them once).  ``scratch``, when
given a dict, receives each quantized row set -- its input (``xn`` LN
output, ``attn`` attention output, ``h`` MLP hidden, as f32), its int8
codes (``xq``, ``aq``, ``hq``) and its row scales (``xs``, ``as``, ``hs``)
-- so a check can hold the kernel's quantization against
the twin's.

``LAUNCHES`` counts kernel launches (CPU twins never count), and
``CORE_ROUTES`` the attention block's by its core's route
(``fused_block.core_route``).  The F-split
of the TPU MLP kernel (per-tile hidden quantization, a VMEM device) is not
ported: both routes quantize the whole hidden row.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..models.layers import ln_f32
from .fused_block import (ACT_KINDS, _act, _check_x, _operand, _raise_on,
                          _route, _stream_ptr, attention_core, core_route)

LAUNCHES: Dict[str, int] = {"attention_block_q": 0,
                            "attention_block_q_causal": 0,
                            "mlp_block_q": 0}
CORE_ROUTES: Dict[str, int] = {"short": 0, "long": 0}
MAX_ROW = 4096  # widest row the CUDA quantize pass holds in registers
S8_GEMM_TILE = 128  # the s8 wgmma GEMM of all four products: N and K multiples of its tile


def reset_launches() -> None:
    for counts in (LAUNCHES, CORE_ROUTES):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Quantization and the exact integer product
# ---------------------------------------------------------------------------


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as an IEEE division.  torch's CUDA division by a Python
    number multiplies by its reciprocal (off by one bit at times); the JAX
    function divides, so the divisor goes in as a tensor on a's device."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def quant_rows(x32: torch.Tensor):
    """Dynamic symmetric per-row int8: f32 [..., n] -> (int8 [..., n], f32
    scale [..., 1]).  scale = max(amax / 127, 1e-8) (the clamp is on the
    scale), q = clip(round_half_even(x / scale), -127, 127)."""
    amax = x32.abs().amax(-1, keepdim=True)
    scale = torch.clamp(true_div(amax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int_mm(a: torch.Tensor, q: torch.Tensor,
           qt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact int32 product of int8 ``a`` [M, K] and int8 ``q`` [K, N].

    CPU: ``torch._int_mm``.  CUDA: cuBLAS's int8 GEMM through
    ``torch._int_mm``, with the weight given column-major (``qt`` [N, K]
    transposed back: its TN layout); it takes M > 16 and K a multiple of 8,
    so a shorter ``a`` is zero-padded in M, and ``a`` and the weight in K
    (ViT-L/14's patch stem has K = 14 * 14 * 3 = 588): zero products, so the
    result is unchanged.  int32 accumulation is exact at every width here
    (K * 127^2 < 2^31 for K < 133,000), whatever TF32 is set to."""
    if not a.is_cuda:
        return torch._int_mm(a, q)
    qt = q.t().contiguous() if qt is None else qt
    m, k = a.shape
    if k % 8:
        a, qt = F.pad(a, (0, -k % 8)), F.pad(qt, (0, -k % 8))
    if m <= 16:
        a = torch.cat([a, a.new_zeros(17 - m, a.shape[1])])
    return torch._int_mm(a, qt.t())[:m]


def dot_q(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
          ws: torch.Tensor, wqt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 [..., K] @ int8 [K, N] -> f32, dequantized (acc * row scale) *
    channel scale (``ws`` [1, N] or [N])."""
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq, wqt)
    acc = acc.reshape(*xq.shape[:-1], wq.shape[-1])
    return acc.float() * xs * ws.reshape(-1).float()


# ---------------------------------------------------------------------------
# Plain twins (the specification)
# ---------------------------------------------------------------------------


def attention_block_q_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q,
                            wo_scale, bo, *, heads: int, causal: bool = False,
                            scratch: Optional[dict] = None) -> torch.Tensor:
    dt = x.dtype
    xn = ln_f32(x, ln_s, ln_b).float()
    xq, xs = quant_rows(xn)
    qkv = (dot_q(xq, xs, wqkv_q, wqkv_scale) + bqkv.float()).to(dt)
    attn = attention_core(qkv, heads, causal).float()
    aq, ascale = quant_rows(attn)
    proj = dot_q(aq, ascale, wo_q, wo_scale) + bo.float()
    if scratch is not None:
        scratch.update({"xn": xn, "xq": xq, "xs": xs, "attn": attn, "aq": aq,
                        "as": ascale})
    return (x.float() + proj).to(dt)


def mlp_block_q_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                      *, act_kind: str = "quick_gelu",
                      scratch: Optional[dict] = None) -> torch.Tensor:
    xn = ln_f32(x, ln_s, ln_b).float()
    xq, xs = quant_rows(xn)
    h = _act(dot_q(xq, xs, w1_q, w1_scale) + b1.float(), act_kind)
    hq, hs = quant_rows(h)
    part = dot_q(hq, hs, w2_q, w2_scale)
    if scratch is not None:
        scratch.update({"xn": xn, "xq": xq, "xs": xs, "h": h, "hq": hq, "hs": hs})
    return ((x.float() + b2.float()) + part).to(x.dtype)


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load

        lib = load("fused_block_q")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dvl_attention_block_q.argtypes = [p] * 17 + [i] * 5 + [p]
        lib.dvl_attention_block_q.restype = i
        lib.dvl_mlp_block_q.argtypes = [p] * 16 + [i] * 4 + [p]
        lib.dvl_mlp_block_q.restype = i
        _LIB = lib
    return _LIB


def build() -> None:
    """Compile (if needed) and load the kernels now rather than at first use."""
    _lib()


def _qweight(qt, scale, n_in: int, n_out: int, name: str, device):
    """The kernel's operands for one weight: the [out, in] int8 copy and the
    [out] f32 channel scales."""
    if qt is None:
        raise ValueError(f"{name}: the CUDA kernel reads the weight transposed "
                         f"([out, in] int8); pass {name}_qt (ops/quant.QWeight "
                         f"holds it)")
    if qt.dtype != torch.int8:
        raise TypeError(f"{name}_qt must be int8, got {qt.dtype}")
    return (_operand(qt, torch.int8, (n_out, n_in), f"{name}_qt", device),
            _operand(scale.reshape(-1), torch.float32, (n_out,),
                     f"{name}_scale", device))


def _attention_block_q_cuda(x, ln_s, ln_b, wqkv_scale, bqkv, wo_scale, bo,
                            heads, causal, wqkv_qt, wo_qt, scratch):
    _check_x(x)
    b, s, d = x.shape
    if d % heads or d // heads != 64:
        raise ValueError(f"the CUDA attention core takes head dim 64, got "
                         f"D={d} heads={heads}")
    if d % S8_GEMM_TILE:
        raise ValueError(f"the CUDA int8 attention block's s8 wgmma GEMM takes D "
                         f"divisible by {S8_GEMM_TILE} (its N and K steps), got "
                         f"D={d}")
    if s < 1:
        raise ValueError(f"sequence length {s} < 1")
    dev = x.device
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    wqkv = _qweight(wqkv_qt, wqkv_scale, d, 3 * d, "wqkv", dev)
    wo = _qweight(wo_qt, wo_scale, d, d, "wo", dev)
    ops = [_operand(ln_s, f32, (d,), "ln_scale", dev),
           _operand(ln_b, f32, (d,), "ln_bias", dev),
           *wqkv, _operand(bqkv, f32, (3 * d,), "bqkv", dev),
           *wo, _operand(bo, f32, (d,), "bo", dev)]
    m = b * s
    out = torch.empty_like(x)
    xn = torch.empty((m, d), dtype=bf, device=dev)
    xq = torch.empty((m, d), dtype=i8, device=dev)
    xs = torch.empty((m,), dtype=f32, device=dev)
    qkv = torch.empty((m, 3 * d), dtype=bf, device=dev)
    attn = torch.empty((m, d), dtype=bf, device=dev)
    aq = torch.empty((m, d), dtype=i8, device=dev)
    ascale = torch.empty((m,), dtype=f32, device=dev)
    err = _lib().dvl_attention_block_q(
        x.data_ptr(), *[t.data_ptr() for t in ops], out.data_ptr(),
        xn.data_ptr(), xq.data_ptr(), xs.data_ptr(), qkv.data_ptr(),
        attn.data_ptr(), aq.data_ptr(), ascale.data_ptr(),
        b, s, d, heads, int(causal), _stream_ptr(dev))
    _raise_on(err, "dvl_attention_block_q")
    LAUNCHES["attention_block_q_causal" if causal else "attention_block_q"] += 1
    CORE_ROUTES[core_route(s)] += 1
    if scratch is not None:
        scratch.update({"xn": xn.view(b, s, d).float(), "xq": xq.view(b, s, d),
                        "xs": xs.view(b, s, 1), "attn": attn.view(b, s, d).float(),
                        "aq": aq.view(b, s, d), "as": ascale.view(b, s, 1)})
    return out


def _mlp_block_q_cuda(x, ln_s, ln_b, w1_scale, b1, w2_scale, b2, act_kind,
                      w1_qt, w2_qt, scratch):
    _check_x(x)
    b, s, d = x.shape
    f = w1_scale.numel()
    if d % S8_GEMM_TILE or f % S8_GEMM_TILE or max(d, f) > MAX_ROW:
        raise ValueError(f"the CUDA int8 MLP's s8 wgmma GEMM takes D and F "
                         f"divisible by {S8_GEMM_TILE} (its N and K steps) and "
                         f"at most {MAX_ROW}, got D={d} F={f}")
    dev = x.device
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    ops = [_operand(ln_s, f32, (d,), "ln_scale", dev),
           _operand(ln_b, f32, (d,), "ln_bias", dev),
           *_qweight(w1_qt, w1_scale, d, f, "w1", dev),
           _operand(b1, f32, (f,), "b1", dev),
           *_qweight(w2_qt, w2_scale, f, d, "w2", dev),
           _operand(b2, f32, (d,), "b2", dev)]
    m = b * s
    out = torch.empty_like(x)
    xn = torch.empty((m, d), dtype=bf, device=dev)
    xq = torch.empty((m, d), dtype=i8, device=dev)
    xs = torch.empty((m,), dtype=f32, device=dev)
    h = torch.empty((m, f), dtype=f32, device=dev)
    hq = torch.empty((m, f), dtype=i8, device=dev)
    hs = torch.empty((m,), dtype=f32, device=dev)
    err = _lib().dvl_mlp_block_q(
        x.data_ptr(), *[t.data_ptr() for t in ops], out.data_ptr(),
        xn.data_ptr(), xq.data_ptr(), xs.data_ptr(), h.data_ptr(),
        hq.data_ptr(), hs.data_ptr(), m, d, f, ACT_KINDS.index(act_kind),
        _stream_ptr(dev))
    _raise_on(err, "dvl_mlp_block_q")
    LAUNCHES["mlp_block_q"] += 1
    if scratch is not None:
        scratch.update({"xn": xn.view(b, s, d).float(), "xq": xq.view(b, s, d),
                        "xs": xs.view(b, s, 1), "h": h.view(b, s, f),
                        "hq": hq.view(b, s, f), "hs": hs.view(b, s, 1)})
    return out


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def attention_block_q(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale,
                      bo, *, heads: int, causal: bool = False,
                      wqkv_qt=None, wo_qt=None,
                      scratch: Optional[dict] = None) -> torch.Tensor:
    """x: [B, S, D] -> x + attn(LN(x)) with int8 QKV and out-projection
    products; ``causal`` applies CLIP's text mask."""
    if _route(x) == "cpu":
        return attention_block_q_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv,
                                       wo_q, wo_scale, bo, heads=heads,
                                       causal=causal, scratch=scratch)
    return _attention_block_q_cuda(x, ln_s, ln_b, wqkv_scale, bqkv, wo_scale,
                                   bo, heads, causal, wqkv_qt, wo_qt, scratch)


def mlp_block_q(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2, *,
                act_kind: str = "quick_gelu", w1_qt=None, w2_qt=None,
                scratch: Optional[dict] = None) -> torch.Tensor:
    """x: [B, S, D] -> x + mlp(LN(x)) with int8 up and down products."""
    if act_kind not in ACT_KINDS:
        raise ValueError(f"act_kind must be one of {ACT_KINDS}, "
                         f"got {act_kind!r}")
    if _route(x) == "cpu":
        return mlp_block_q_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q,
                                 w2_scale, b2, act_kind=act_kind, scratch=scratch)
    return _mlp_block_q_cuda(x, ln_s, ln_b, w1_scale, b1, w2_scale, b2,
                             act_kind, w1_qt, w2_qt, scratch)


def fused_resblock_q(blk, x: torch.Tensor, heads: int, *,
                     act_kind: str = "quick_gelu",
                     causal: bool = False) -> torch.Tensor:
    """One residual block (an ``ops/quant.QuantBlock``) through the two int8
    entry points."""
    x = attention_block_q(x, blk.ln_1.scale, blk.ln_1.bias, blk.wqkv.q,
                          blk.wqkv.scale, blk.bqkv, blk.wo.q, blk.wo.scale,
                          blk.bo, heads=heads, causal=causal,
                          wqkv_qt=blk.wqkv.qt, wo_qt=blk.wo.qt)
    return mlp_block_q(x, blk.ln_2.scale, blk.ln_2.bias, blk.w1.q,
                       blk.w1.scale, blk.b1, blk.w2.q, blk.w2.scale, blk.b2,
                       act_kind=act_kind, w1_qt=blk.w1.qt, w2_qt=blk.w2.qt)


def fused_transformer_q(blocks, x: torch.Tensor, heads: int, *,
                        act_kind: str = "quick_gelu",
                        causal: bool = False) -> torch.Tensor:
    for blk in blocks:
        x = fused_resblock_q(blk, x, heads, act_kind=act_kind, causal=causal)
    return x
