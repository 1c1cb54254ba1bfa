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
(``fused_block.core_route``).  ``mlp_block_q(fb=)`` is the TPU MLP
kernel's F-split: with ``fb`` < F each fb-wide chunk of a hidden row is
quantized with its own scale and the chunks' dequantized down products are
summed in f32 (``KB_LAUNCHES["mlp_block_q_fsplit"]`` counts the card's
launches; any divisor fb of F: the card pads each chunk to a multiple of
128, ``fused_block.mlp_plan``).  K3, K4 and every KB entry below take any
D, head dim and F on the card, on the padded operand layouts of
``fused_block.attn_plan`` / ``mlp_plan`` (``q_attn_operands`` /
``q_mlp_operands``; the identity at the registry archs' widths).

The tensor-parallel shares take any head group and any hidden columns: each
slot's operands on ``fused_block.group_plan`` / ``mlp_plan``; up to
``fused_block.TP_PARTS`` slots.

The tensor-parallel shares (``parallel/tensor.py``; ``TP_LAUNCHES``): a
slot's head group (``attention_block_q_heads``) or hidden columns
(``mlp_block_q_cols``) up to the row-parallel input and its row amax;
``rows_q_partial`` quantizes that input at the row's global scale (the max
of every slot's amax: the unsharded block's scale, so its codes) into a raw
int32 partial; ``tp_reduce_q`` sums the partials exactly (the unsharded K
loop's int32 sum) and dequantizes once -- bit-equal to K3 / K4.  On the
card a slot entry normalises and quantizes x in one pass, the attention
slot ends in a row-amax pass and the MLP slot takes its amax in the up
GEMM's epilogue; its operands (the LayerNorm parameters and the slot's
weight, scale and bias on its padded layout) are kept per version of each,
so a call past the first checks, casts and copies nothing.  ``rows_q_partial``
takes one of two routes (``rows_route``; counted in ``ROWS_ROUTES``, and by
its input's dtype in ``ROWS_INPUTS``): where the product's K is narrow (a
multiple of 64 up to 384: a head group's g hdp columns, a slot's hidden
columns at m = 8) and the int32 rows are whole 16-byte units, one launch of
the row-strip kernel (``rows_strip_q_kernel``:
each 128-row strip quantized into shared memory, every N tile of the weight
walked on it by s8 wgmma, each int32 tile stored by TMA while the next one's
products run): "strip"; else a warp-a-row quantize pass, then the s8 GEMM
writing raw int32: "gemm".  Both give the same codes, scales and partial.

The int8 kernel experiments of ``benchmarks/`` (KB (a) 1-4; ``KB_LAUNCHES``),
each K3 or K4 with one change, on the same launches:

  attention_block_qq     (attn_int8_cores.py) qkv kept f32; the core's QK^T
                         and P V int8 (``attention_qq_core``: q, k per row,
                         p per row, v per column over the keys; any head
                         dim and S, ``qq_route``)
  mlp_block_q_bf16h      (q_mlp_bf16h.py) the up-projection's deq + b1
                         rounded to bf16 before quick_gelu and the quantize;
                         on the card LayerNorm and quantize in one pass, the
                         up product on the persistent TMA-store GEMM
                         (``BF16H_ROUTES``), the gelu-and-quantize pass 16
                         bytes a load
  mlp_block_q_var        (q_kernel_variants.py) the reciprocal quantizer
                         (``quant_rows_recip``), optionally a bf16 quick_gelu;
                         on the card LayerNorm and quantize in one pass
                         (``VAR_ROUTES``)
  attention_block_q_var  (q_kernel_variants.py) the reciprocal quantizer,
                         exp2 at hd^-0.5 log2 e, the row sum divided out
                         after P V

and, beside them (``KB_LAUNCHES``):

  mlp_block_q(fb=F/k)        (q_ilp.py::make_fsplit(k), KB (a) 7) K4's F-split;
                             on the card LayerNorm and quantize in one pass,
                             the chunked down product on the epilogue-warpgroup
                             GEMM where ``fsplit_route`` takes it
                             (``FSPLIT_ROUTES``)
  fused_layer_q              (q_layer_fused.py) K3 then K4 in one call, the
                             attention half's x + proj kept f32 for the MLP
                             half's residual (only LayerNorm reads it in bf16);
                             on the card LayerNorm and quantize in one pass at
                             both norms, the QKV and down products on
                             persistent GEMMs (``layer_route``)
  attention_block_q_postdiv  (q_ilp4.py, the head-pair packed kernel) K3 with
                             the row sum divided out after P V; on the card
                             LayerNorm and quantize in one pass, the QKV
                             product on the persistent TMA-store GEMM
                             (``POSTDIV_ROUTES``)

and the two blocks of benchmarks/q_attribution.py (KB (c)), each in three
modes (``ATTR_MODES``): "full" is K3 / K4 itself (its launch and its
``LAUNCHES`` counter); "mxu" keeps the products and drops the elementwise
chain (x cast to int8 as clip(x 16, +-127) toward zero with row scale 1/16,
the hidden and the attention rows cast to int8 with row scale 1, the
attention core without its softmax: p = s hd^-0.5 rounded to x's dtype);
"vpu" keeps the chain and stands a broadcast in for every product (a row's
first code times its scale, for each output column; each score row is its
query's first element).  The casts are XLA's float-to-int8 conversion
(``to_s8_sat``), not quant_rows.  ``KB_LAUNCHES`` counts the "mxu" and "vpu"
launches:

  mlp_block_q_attr        (make_mlp(mode), mlp_kernel)
  attention_block_q_attr  (make_attn(mode), attn_kernel)
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..models.layers import ln_f32, quick_gelu
from ..utils.observability import check_nans
from .fused_block import (ACT_KINDS, AttnPlan, MlpPlan, _act, _check_x,
                          _head_qkv, _operand, _raise_on, _route, _stream_ptr, attention_core,
                          attn_plan, check_parts, core_route, group_plan, mlp_plan, pad_cols,
                          place, planned, round_up)

LAUNCHES: Dict[str, int] = {"attention_block_q": 0,
                            "attention_block_q_causal": 0,
                            "mlp_block_q": 0}
CORE_ROUTES: Dict[str, int] = {"short": 0, "long": 0}
TP_LAUNCHES: Dict[str, int] = {"attention_block_q_heads": 0,
                               "attention_block_q_heads_causal": 0,
                               "mlp_block_q_cols": 0,
                               "rows_q_partial": 0,
                               "tp_reduce_q": 0}
KB_LAUNCHES: Dict[str, int] = {"attention_block_qq": 0,
                               "attention_qq_core": 0,
                               "mlp_block_q_bf16h": 0,
                               "mlp_block_q_var": 0,
                               "mlp_block_q_var_bf16_gelu": 0,
                               "attention_block_q_var": 0,
                               "mlp_block_q_fsplit": 0,
                               "fused_layer_q": 0,
                               "attention_block_q_postdiv": 0,
                               "attention_block_q_attr_mxu": 0,
                               "attention_block_q_attr_vpu": 0,
                               "mlp_block_q_attr_mxu": 0,
                               "mlp_block_q_attr_vpu": 0}
# the routes of ``rows_q_partial``'s calls (``rows_route``): one launch of the
# row-strip kernel ("strip") or the quantize pass and the s8 GEMM ("gemm")
ROWS_ROUTES: Dict[str, int] = {"strip": 0, "gemm": 0}
# and by their input: an attention slot's bf16 rows, an MLP slot's f32 hidden
ROWS_INPUTS: Dict[str, int] = {"bf16": 0, "f32": 0}
# the routes of ``fused_layer_q``'s calls (``layer_route``): its QKV and down
# products on the persistent GEMMs ("tma"), the QKV product alone where the
# down product's rows are not whole 16-byte units ("qkv"), or, for the
# checks, neither ("gemm", ``_fused_layer_q_cuda(..., tma=False)``)
LAYER_ROUTES: Dict[str, int] = {"tma": 0, "qkv": 0, "gemm": 0}
# the routes of the F-split's calls (``fsplit_route``): its down product on
# the epilogue-warpgroup GEMM ("epi"), or on the chunked s8 GEMM where the
# output rows are not whole 16-byte units or for the checks ("gemm",
# ``_mlp_block_q_cuda(..., tma=False)``)
FSPLIT_ROUTES: Dict[str, int] = {"epi": 0, "gemm": 0}
# and of ``mlp_block_q_bf16h``'s: its up product on the persistent TMA-store
# GEMM ("tma"), or on the s8 GEMM for the checks ("gemm")
BF16H_ROUTES: Dict[str, int] = {"tma": 0, "gemm": 0}
# the routes of ``mlp_block_q_var``'s calls: LayerNorm and the reciprocal
# quantize of x in one pass, then K4's up GEMM, quantize pass and down GEMM
# ("ln", four launches), or the launches before, for the checks ("gemm",
# ``_mlp_block_q_cuda(..., tma=False)``)
VAR_ROUTES: Dict[str, int] = {"ln": 0, "gemm": 0}
# and of ``attention_block_q_postdiv``'s: LayerNorm and quantize in one, the
# QKV product on the persistent TMA-store GEMM and the core's divide-after
# instantiation ("tma"), or K3's launches for the checks ("gemm")
POSTDIV_ROUTES: Dict[str, int] = {"tma": 0, "gemm": 0}
S8_GEMM_TILE = 128  # the s8 wgmma GEMM's N tile
QQ_MAX_SEQ = 256  # keys of a score row the int8 core's register route holds
# KB (a) 1's int8 core launches by route (``qq_route``)
QQ_ROUTES: Dict[str, int] = {"register": 0, "tiled": 0}
LOG2E = 1.4426950408889634
ATTR_MODES = ("full", "mxu", "vpu")  # benchmarks/q_attribution.py's kernel bodies
ATTR_X_SCALE = 1.0 / 16.0  # the "mxu" bodies' static row scale of x


def reset_launches() -> None:
    for counts in (LAUNCHES, CORE_ROUTES, TP_LAUNCHES, KB_LAUNCHES, QQ_ROUTES, ROWS_ROUTES,
                   ROWS_INPUTS, LAYER_ROUTES, FSPLIT_ROUTES, BF16H_ROUTES, VAR_ROUTES,
                   POSTDIV_ROUTES):
        for k in counts:
            counts[k] = 0


def qq_route(s: int, hd: int) -> str:
    """The route KB (a) 1's int8 core (csrc/attention_qq.cuh) takes at ``s``
    keys and head dim ``hd``: "register" (whole score rows in registers) at
    head dim 64 up to ``QQ_MAX_SEQ`` keys, "tiled" (64-key tiles, two passes,
    any head dim zero-padded to a multiple of 64) otherwise."""
    if s < 1:
        raise ValueError(f"sequence length {s} < 1")
    return "register" if round_up(hd, 64) == 64 and s <= QQ_MAX_SEQ else "tiled"


# ---------------------------------------------------------------------------
# Quantization and the exact integer product
# ---------------------------------------------------------------------------


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as an IEEE division.  torch's CUDA division by a Python
    number multiplies by its reciprocal (off by one bit at times); the JAX
    function divides, so the divisor goes in as a tensor on a's device."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def q_codes(y: torch.Tensor) -> torch.Tensor:
    """clip(round_half_even(y), -127, 127) as int8, a NaN to 0 (XLA's
    conversion, ``to_s8_sat``; torch's cast of a NaN is the host's)."""
    y = torch.clamp(torch.round(y), -127, 127)
    return torch.where(torch.isnan(y), 0.0, y).to(torch.int8)


def quant_rows(x32: torch.Tensor):
    """Dynamic symmetric per-row int8: f32 [..., n] -> (int8 [..., n], f32
    scale [..., 1]).  scale = max(amax / 127, 1e-8) (the clamp is on the
    scale), q = clip(round_half_even(x / scale), -127, 127).  A row holding
    a NaN gets a NaN amax and scale (torch's amax and clamp propagate it, as
    jnp.max and jnp.maximum do) and codes 0."""
    amax = x32.abs().amax(-1, keepdim=True)
    scale = torch.clamp(true_div(amax, 127.0), min=1e-8)
    return q_codes(x32 / scale), scale


def quant_rows_recip(x32: torch.Tensor):
    """``_quant_rows_recip`` of benchmarks/q_kernel_variants.py: quant_rows's
    scale, and q = clip(round_half_even(x * inv), -127, 127) with inv =
    1 / scale, one IEEE division per row (a tensor divisor, as ``true_div``:
    torch's CUDA division by a Python number multiplies by its reciprocal).
    A code can differ from quant_rows's where x * inv rounds across a
    half."""
    amax = x32.abs().amax(-1, keepdim=True)
    scale = torch.clamp(true_div(amax, 127.0), min=1e-8)
    inv = torch.ones((), dtype=scale.dtype, device=scale.device) / scale
    return q_codes(x32 * inv), scale


def to_s8_sat(x: torch.Tensor) -> torch.Tensor:
    """XLA's float-to-int8 conversion (``x.astype(jnp.int8)``): toward zero,
    saturated to [-128, 127], NaN to 0.  torch's ``.to(torch.int8)`` wraps
    out-of-range values instead (300 -> 44)."""
    x = x.float()
    return torch.where(torch.isnan(x), 0.0, x.clamp(-128.0, 127.0)).trunc().to(torch.int8)


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


def attention_block_q_padded(x, ln_s, ln_b, wqkv_p, wqkv_scale_p, bqkv_p, wo_p, wo_scale_p,
                             bo_p, *, plan: AttnPlan, causal: bool = False,
                             scratch: Optional[dict] = None) -> torch.Tensor:
    """K3's function as its kernel computes it on the padded operand layout
    (``q_attn_operands``: wqkv_p [nqkv, dk] and wo_p [no, da] int8 in the
    kernel's [out, in] layout, their channel scales and biases f32): every
    row quantized at its padded width (zero lanes: the same amax and codes),
    the core over hdp lanes a head at the true head dim's scale.  The
    scratch holds the padded rows."""
    dt = x.dtype
    xn = pad_cols(ln_f32(x, ln_s, ln_b).float(), plan.dk)
    xq, xs = quant_rows(xn)
    qkv = (dot_q(xq, xs, wqkv_p.t(), wqkv_scale_p) + bqkv_p.float()).to(dt)
    attn = attention_core(qkv[..., :3 * plan.da], plan.heads, causal, scale=plan.scale).float()
    aq, ascale = quant_rows(attn)
    proj = (dot_q(aq, ascale, wo_p.t(), wo_scale_p) + bo_p.float())[..., :plan.d]
    if scratch is not None:
        scratch.update({"xn": xn, "xq": xq, "xs": xs, "attn": attn, "aq": aq, "as": ascale})
    return (x.float() + proj).to(dt)


def mlp_block_q_padded(x, ln_s, ln_b, w1_p, w1_scale_p, b1_p, w2_p, w2_scale_p, b2_p, *,
                       plan: MlpPlan, act_kind: str = "quick_gelu",
                       scratch: Optional[dict] = None) -> torch.Tensor:
    """K4's function on the padded operand layout (``q_mlp_operands``): the
    hidden's k chunks each padded to fbp lanes (gelu(0) = 0), each chunk's
    rows quantized at its padded width, the chunks' products summed in f32
    in chunk order."""
    d = plan.d
    xn = pad_cols(ln_f32(x, ln_s, ln_b).float(), plan.dk)
    xq, xs = quant_rows(xn)
    h = _act(dot_q(xq, xs, w1_p.t(), w1_scale_p) + b1_p.float(), act_kind)
    part, hq, hs = fsplit_down(h, w2_p.t(), w2_scale_p, plan.fbp)
    if scratch is not None:
        scratch.update({"xn": xn, "xq": xq, "xs": xs, "h": h.reshape(hq.shape), "hq": hq,
                        "hs": hs})
    return ((x.float() + b2_p[:d].float()) + part[..., :d]).to(x.dtype)


def q_attn_operands(wqkv_qt, wqkv_scale, bqkv, wo_qt, wo_scale, bo, plan: AttnPlan):
    """K3's kernel operands on ``plan``'s layout: the [out, in] int8 copies
    (``QWeight.qt``) with each head's q, k, v rows and wo columns at hdp
    lanes, zeros elsewhere; the channel scales and biases f32 alike (zero
    scales in the padding)."""
    cols, f32 = plan.qkv_columns(), torch.float32
    return (place(wqkv_qt, (plan.nqkv, plan.dk), rows=cols),
            place(wqkv_scale.reshape(-1).to(f32), (plan.nqkv,), rows=cols),
            place(bqkv.detach().to(f32), (plan.nqkv,), rows=cols),
            place(wo_qt, (plan.no, plan.da), cols=plan.head_lanes()),
            place(wo_scale.reshape(-1).to(f32), (plan.no,)),
            place(bo.detach().to(f32), (plan.no,)))


def q_mlp_operands(w1_qt, w1_scale, b1, w2_qt, w2_scale, b2, plan: MlpPlan):
    """K4's kernel operands on ``plan``'s layout: w1_qt's rows, w1's scales
    and b1 at the hidden's padded lanes, w2_qt's columns alike."""
    cols, f32 = plan.hidden_columns(), torch.float32
    return (place(w1_qt, (plan.fp, plan.dk), rows=cols),
            place(w1_scale.reshape(-1).to(f32), (plan.fp,), rows=cols),
            place(b1.detach().to(f32), (plan.fp,), rows=cols),
            place(w2_qt, (plan.no, plan.fp), cols=cols),
            place(w2_scale.reshape(-1).to(f32), (plan.no,)),
            place(b2.detach().to(f32), (plan.no,)))


def check_fb(f: int, fb) -> int:
    """The F-tile of ``mlp_block_q``: F when None, else a divisor of F
    (JAX's refusal otherwise)."""
    fb = f if fb is None else fb
    if fb < 1 or f % fb:
        raise ValueError(f"mlp dim {f} not divisible by fb={fb} — the "
                         "F-tile loop would truncate the hidden sum")
    return fb


def fsplit_down(h: torch.Tensor, w2_q, w2_scale, fb: int):
    """The F-split down product: h [..., F] f32 viewed as [..., F / fb, fb],
    each chunk's rows quantized on their own, each chunk's dequantized
    product (acc * chunk scale) * channel scale, summed in f32 in chunk
    order.  Returns (sum [..., D], codes [..., k, fb], scales [..., k, 1])."""
    k = h.shape[-1] // fb
    hq, hs = quant_rows(h.reshape(*h.shape[:-1], k, fb))
    part = None
    for c in range(k):
        p = dot_q(hq[..., c, :], hs[..., c, :], w2_q[c * fb:(c + 1) * fb], w2_scale)
        part = p if part is None else part + p
    return part, hq, hs


def mlp_block_q_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                      *, act_kind: str = "quick_gelu", fb: Optional[int] = None,
                      scratch: Optional[dict] = None) -> torch.Tensor:
    """K4's twin.  With ``fb`` < F (``fsplit_down``), the scratch's h, hq
    and hs are per chunk: [..., F / fb, fb] and [..., F / fb, 1]."""
    f = w1_scale.numel()
    fb = check_fb(f, fb)
    xn = ln_f32(x, ln_s, ln_b).float()
    xq, xs = quant_rows(xn)
    h = _act(dot_q(xq, xs, w1_q, w1_scale) + b1.float(), act_kind)
    if fb == f:
        hq, hs = quant_rows(h)
        part = dot_q(hq, hs, w2_q, w2_scale)
    else:
        part, hq, hs = fsplit_down(h, w2_q, w2_scale, fb)
        h = h.reshape(hq.shape)
    if scratch is not None:
        scratch.update({"xn": xn, "xq": xq, "xs": xs, "h": h, "hq": hq, "hs": hs})
    return ((x.float() + b2.float()) + part).to(x.dtype)


def fused_layer_q_plain(x, ln1_s, ln1_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale, bo,
                        ln2_s, ln2_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2, *,
                        heads: int, scratch: Optional[dict] = None) -> torch.Tensor:
    """``layer_kernel`` of benchmarks/q_layer_fused.py: K3's function up to
    y = x + proj kept f32, K4's LayerNorm on bf16(y) (y rounded to x's
    dtype), quick_gelu, and the output (y + b2) + part rounded once.  The
    scratch holds the attention half's rows and codes under K3's keys, y
    (f32), and the MLP half's under yn, yq, ys, h, hq, hs."""
    dt = x.dtype
    xn = ln_f32(x, ln1_s, ln1_b).float()
    xq, xs = quant_rows(xn)
    qkv = (dot_q(xq, xs, wqkv_q, wqkv_scale) + bqkv.float()).to(dt)
    attn = attention_core(qkv, heads, False).float()
    aq, ascale = quant_rows(attn)
    y = x.float() + (dot_q(aq, ascale, wo_q, wo_scale) + bo.float())
    yn = ln_f32(y.to(dt), ln2_s, ln2_b).float()
    yq, ys = quant_rows(yn)
    h = quick_gelu(dot_q(yq, ys, w1_q, w1_scale) + b1.float())
    hq, hs = quant_rows(h)
    part = dot_q(hq, hs, w2_q, w2_scale)
    if scratch is not None:
        scratch.update({"xn": xn, "xq": xq, "xs": xs, "attn": attn, "aq": aq, "as": ascale,
                        "y": y, "yn": yn, "yq": yq, "ys": ys, "h": h, "hq": hq, "hs": hs})
    return ((y + b2.float()) + part).to(dt)


def row_amax(a: torch.Tensor) -> torch.Tensor:
    """|a|'s max over the last dim, f32 [..., 1]: ``quant_rows``'s amax."""
    return a.float().abs().amax(-1, keepdim=True)


def attention_block_q_heads_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, *,
                                  heads: int, causal: bool = False):
    """A head group's int8 attention up to its out-projection: ``wqkv_q``
    [D, 3 g hd] / ``wqkv_scale`` [1, 3 g hd] / ``bqkv`` the group's q | k | v
    output channels, ``heads`` = g.  Returns (attn [B, S, g hd] in x's
    dtype, its row amax f32 [B, S, 1])."""
    dt = x.dtype
    xq, xs = quant_rows(ln_f32(x, ln_s, ln_b).float())
    qkv = (dot_q(xq, xs, wqkv_q, wqkv_scale) + bqkv.float()).to(dt)
    attn = attention_core(qkv, heads, causal)
    return attn, row_amax(attn)


def mlp_block_q_cols_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, *,
                           act_kind: str = "quick_gelu"):
    """A slot's int8 MLP up to its down-projection over hidden columns
    ``w1_q`` [D, Fj]: (the f32 hidden [B, S, Fj], its row amax)."""
    xq, xs = quant_rows(ln_f32(x, ln_s, ln_b).float())
    h = _act(dot_q(xq, xs, w1_q, w1_scale) + b1.float(), act_kind)
    return h, row_amax(h)


def quant_rows_given_amax(x32: torch.Tensor, amax: torch.Tensor):
    """``quant_rows`` at a given row amax (f32 [..., 1]; a NaN amax gives a
    NaN scale and codes 0)."""
    scale = torch.clamp(true_div(amax, 127.0), min=1e-8)
    return q_codes(x32 / scale), scale


def rows_q_partial_plain(a, amaxes, w_q):
    """A slot's row-parallel int8 product: ``a`` [..., K] quantized at the
    row scale of max(amaxes) (every slot's row amax of the whole row), times
    its rows of the weight ``w_q`` [K, N] int8 -> (int32 [..., N], codes,
    row scales [..., 1])."""
    amax = amaxes[0]
    for other in amaxes[1:]:
        amax = torch.maximum(amax, other.to(amax.device))
    aq, ascale = quant_rows_given_amax(a.float(), amax)
    acc = int_mm(aq.reshape(-1, aq.shape[-1]), w_q).reshape(*aq.shape[:-1], w_q.shape[-1])
    return acc, aq, ascale


def tp_reduce_q_plain(parts, ascale, w_scale, bias, resid, *, bias_first: bool):
    """The int32 partials summed exactly, dequantized (acc * row scale) *
    channel scale, then resid + (deq + bias) (the attention half, K3's
    order) or (resid + bias) + deq (``bias_first``, K4's), in resid's dtype."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    deq = acc.float() * ascale * w_scale.reshape(-1).float()
    r, b = resid.float(), bias.float()
    return (((r + b) + deq) if bias_first else (r + (deq + b))).to(resid.dtype)


# KB (a) 1-4: the twins follow their Pallas bodies line for line, with the
# roundings XLA's CPU backend performs (the excess-precision rewrite drops
# the last bf16 rounding of a bf16 chain whose result goes straight back to
# f32: the bf16 quick_gelu's division stays f32)


def _bmm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched int8 [..., M, K] @ int8 [..., K, N] -> int32, exact: float64
    products and sums of integers below 2^53."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def attention_qq_core_plain(qkv32: torch.Tensor, heads: int, out_dtype,
                            scratch: Optional[dict] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """The int8 attention core of ``_attn_qq_kernel`` (benchmarks/
    attn_int8_cores.py): qkv f32 [B, S, 3D] -> [B, S, D] in ``out_dtype``.
    Per head: q and k quantized per row (over hd), scores = ((int32 q k^T *
    q scale) * k scale^T) * hd^-0.5, softmax with exp and a division, p
    quantized per row (over the keys), v^T per row (each channel over the
    keys), o = (int32 p v * p scale) * v scale^T rounded to ``out_dtype``.
    ``scratch`` receives the probabilities ``p`` [B, H, S, S] f32, their
    codes ``pq`` and row scales ``psc`` [B, H, S, 1].  ``scale`` replaces
    hd^-0.5 (the padded layout's core keeps the true head dim's)."""
    d = qkv32.shape[-1] // 3
    hd = d // heads
    scale = 1.0 / hd ** 0.5 if scale is None else scale
    outs, ps = [], []
    for h in range(heads):
        q, k, v = _head_qkv(qkv32, heads, h)
        qq, qsc = quant_rows(q)
        kq, ksc = quant_rows(k)
        sc = _bmm_exact(qq, kq.transpose(1, 2)).float() * qsc * ksc.transpose(1, 2) * scale
        e = torch.exp(sc - sc.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
        pq, psc = quant_rows(p)
        vq, vsc = quant_rows(v.transpose(1, 2))
        o = _bmm_exact(pq, vq.transpose(1, 2)).float() * psc * vsc.transpose(1, 2)
        outs.append(o.to(out_dtype))
        ps.append((p, pq, psc))
    if scratch is not None:
        for i, key in enumerate(("p", "pq", "psc")):
            scratch[key] = torch.stack([t[i] for t in ps], 1)
    return torch.cat(outs, -1)


def attention_block_qq_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale, bo, *,
                             heads: int, scratch: Optional[dict] = None) -> torch.Tensor:
    """KB (a) 1 (``attention_block_qq``): K3 with qkv kept f32 and the int8
    core of ``attention_qq_core_plain``."""
    dt = x.dtype
    xn = ln_f32(x, ln_s, ln_b).float()
    xq, xs = quant_rows(xn)
    qkv = dot_q(xq, xs, wqkv_q, wqkv_scale) + bqkv.float()
    attn = attention_qq_core_plain(qkv, heads, dt).float()
    aq, ascale = quant_rows(attn)
    proj = dot_q(aq, ascale, wo_q, wo_scale) + bo.float()
    if scratch is not None:
        scratch.update({"xn": xn, "xq": xq, "xs": xs, "qkv": qkv, "attn": attn, "aq": aq,
                        "as": ascale})
    return (x.float() + proj).to(dt)


def mlp_block_q_bf16h_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2, *,
                            scratch: Optional[dict] = None) -> torch.Tensor:
    """KB (a) 2 (``pipe_kernel`` of benchmarks/q_mlp_bf16h.py with bf16h):
    K4 with the up-projection's deq + b1 rounded to bf16 (``u``) before
    quick_gelu and the quantize."""
    xn = ln_f32(x, ln_s, ln_b).float()
    xq, xs = quant_rows(xn)
    u = (dot_q(xq, xs, w1_q, w1_scale) + b1.float()).to(torch.bfloat16)
    h = quick_gelu(u.float())
    hq, hs = quant_rows(h)
    part = dot_q(hq, hs, w2_q, w2_scale)
    if scratch is not None:
        scratch.update({"xn": xn, "xq": xq, "xs": xs, "u": u, "h": h, "hq": hq, "hs": hs})
    return ((x.float() + b2.float()) + part).to(x.dtype)


def quick_gelu_bf16(h: torch.Tensor) -> torch.Tensor:
    """``mlp_q_kernel_var``'s bf16 quick_gelu as XLA evaluates it: hb =
    bf16(h); hb / (1 + exp(bf16(-1.702) hb)) with the product, the exp and
    the sum each rounded to bf16 and the division left in f32."""
    hb = h.to(torch.bfloat16)
    den = 1 + torch.exp(torch.tensor(-1.702, dtype=torch.bfloat16, device=h.device) * hb)
    return hb.float() / den.float()


def mlp_block_q_var_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2, *,
                          bf16_gelu: bool = False,
                          scratch: Optional[dict] = None) -> torch.Tensor:
    """KB (a) 3 (``mlp_q_kernel_var``): K4 with ``quant_rows_recip`` on x
    and on the hidden, quick_gelu in f32 or (``bf16_gelu``) bf16."""
    xn = ln_f32(x, ln_s, ln_b).float()
    xq, xs = quant_rows_recip(xn)
    h = dot_q(xq, xs, w1_q, w1_scale) + b1.float()
    h = quick_gelu_bf16(h) if bf16_gelu else quick_gelu(h)
    hq, hs = quant_rows_recip(h)
    part = dot_q(hq, hs, w2_q, w2_scale)
    if scratch is not None:
        scratch.update({"xn": xn, "xq": xq, "xs": xs, "h": h, "hq": hq, "hs": hs})
    return ((x.float() + b2.float()) + part).to(x.dtype)


def _attention_block_q_postdiv(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale, bo,
                               heads, scratch, quant, base2):
    """K3 with the softmax's row sum divided out after P V: scores times
    hd^-0.5 (with exp) or hd^-0.5 log2 e (``base2``, with exp2), the
    unnormalised exponentials rounded to x's dtype for P V, the f32 output
    divided by the f32 row sum; ``quant`` on x and on the attention rows."""
    dt = x.dtype
    xn = ln_f32(x, ln_s, ln_b).float()
    xq, xs = quant(xn)
    qkv = (dot_q(xq, xs, wqkv_q, wqkv_scale) + bqkv.float()).to(dt)
    hd = qkv.shape[-1] // 3 // heads
    scale = (1.0 / hd ** 0.5) * (LOG2E if base2 else 1.0)
    outs = []
    for h in range(heads):
        q, k, v = (t.float() for t in _head_qkv(qkv, heads, h))
        sc = torch.matmul(q, k.transpose(1, 2)) * scale
        sc = sc - sc.amax(-1, keepdim=True)
        e = torch.exp2(sc) if base2 else torch.exp(sc)
        o = torch.matmul(e.to(dt).float(), v)
        outs.append((o / e.sum(-1, keepdim=True)).to(dt))
    attn = torch.cat(outs, -1).float()
    aq, ascale = quant(attn)
    proj = dot_q(aq, ascale, wo_q, wo_scale) + bo.float()
    if scratch is not None:
        scratch.update({"xn": xn, "xq": xq, "xs": xs, "attn": attn, "aq": aq, "as": ascale})
    return (x.float() + proj).to(dt)


def attention_block_q_var_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale, bo,
                                *, heads: int, scratch: Optional[dict] = None) -> torch.Tensor:
    """KB (a) 4 (``attn_q_kernel_var``, either ``packed``: the head-pair
    packing only regroups the same products): K3 with ``quant_rows_recip``
    on x and on the attention rows; scores times hd^-0.5 log2 e, exp2,
    the unnormalised exponentials rounded to x's dtype for P V, and the f32
    output divided by the f32 row sum after it."""
    return _attention_block_q_postdiv(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale,
                                      bo, heads, scratch, quant_rows_recip, True)


def attention_block_q_postdiv_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale,
                                    bo, *, heads: int,
                                    scratch: Optional[dict] = None) -> torch.Tensor:
    """The head-pair packed kernel of benchmarks/q_ilp4.py (``make_kernel``;
    the block-diagonal Q only regroups the same products): K3 with exp at
    hd^-0.5, the unnormalised exponentials rounded to x's dtype for P V and
    the f32 output divided by the f32 row sum after it (its ``o / l``)."""
    return _attention_block_q_postdiv(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale,
                                      bo, heads, scratch, quant_rows, False)


# KB (c): benchmarks/q_attribution.py's "mxu" and "vpu" bodies


def _check_attr_mode(mode: str) -> None:
    if mode not in ATTR_MODES:
        raise ValueError(f"mode must be one of {ATTR_MODES}, got {mode!r}")


def static_q(x: torch.Tensor):
    """The "mxu" bodies' x codes: int8(clip(x 16, -127, 127)) toward zero,
    with the constant row scale 1/16 ([..., 1] f32)."""
    xq = to_s8_sat(torch.clamp(x.float() * 16.0, -127.0, 127.0))
    return xq, torch.full((*x.shape[:-1], 1), ATTR_X_SCALE, device=x.device)


def unit_q(a: torch.Tensor):
    """The "mxu" bodies' hidden and attention codes: ``to_s8_sat`` with the
    row scale 1."""
    return to_s8_sat(a), torch.ones((*a.shape[:-1], 1), device=a.device)


def bcast_rows(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """The "vpu" bodies' stand-in for a product: each row's first code times
    its row scale, the same f32 value in all n columns."""
    return (q[..., :1].float() * scale).expand(*q.shape[:-1], n)


def attention_core_nosoftmax(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """The "mxu" attention core: per head f32 scores times hd^-0.5 rounded
    to qkv's dtype as p (no max, exp, sum or division), P V in f32, each
    head's output rounded to qkv's dtype."""
    dt = qkv.dtype
    hd = qkv.shape[-1] // 3 // heads
    outs = []
    for h in range(heads):
        q, k, v = (t.float() for t in _head_qkv(qkv, heads, h))
        p = (torch.matmul(q, k.transpose(1, 2)) * (1.0 / hd ** 0.5)).to(dt)
        outs.append(torch.matmul(p.float(), v).to(dt))
    return torch.cat(outs, -1)


def attention_core_vpu(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """The "vpu" attention core: per head every score of a query row is
    its q's first element times hd^-0.5 (f32); the softmax as K3's (row
    max, exp, row sum, division, p rounded to qkv's dtype); the head's
    output is each row's first p in all hd columns."""
    dt = qkv.dtype
    b, s = qkv.shape[:2]
    hd = qkv.shape[-1] // 3 // heads
    outs = []
    for h in range(heads):
        q = next(_head_qkv(qkv, heads, h))
        sc = q[..., :1].float().expand(b, s, s) * (1.0 / hd ** 0.5)
        e = torch.exp(sc - sc.amax(-1, keepdim=True))
        p = (e / e.sum(-1, keepdim=True)).to(dt)
        outs.append(p[..., :1].float().expand(b, s, hd).to(dt))
    return torch.cat(outs, -1)


def mlp_block_q_attr_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2, *, mode: str,
                           scratch: Optional[dict] = None) -> torch.Tensor:
    """``mlp_kernel`` of benchmarks/q_attribution.py.  "full": K4 with
    quick_gelu.  "mxu": h = dot_q(static_q(x)) + b1, its codes ``unit_q(h)``,
    out = (x + b2) + dot_q(those codes).  "vpu": LN and quant_rows; h =
    quick_gelu(bcast_rows(x codes) + b1), quant_rows(h), out = (x + b2) +
    bcast_rows(h codes)."""
    _check_attr_mode(mode)
    if mode == "full":
        return mlp_block_q_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                                 scratch=scratch)
    f, d = w1_scale.numel(), x.shape[-1]
    rows = {}
    if mode == "mxu":
        xq, xs = static_q(x)
        h = dot_q(xq, xs, w1_q, w1_scale) + b1.float()
        hq, hs = unit_q(h)
        part = dot_q(hq, hs, w2_q, w2_scale)
    else:
        rows["xn"] = ln_f32(x, ln_s, ln_b).float()
        xq, xs = quant_rows(rows["xn"])
        h = quick_gelu(bcast_rows(xq, xs, f) + b1.float())
        hq, hs = quant_rows(h)
        part = bcast_rows(hq, hs, d)
    if scratch is not None:
        scratch.update({**rows, "xq": xq, "xs": xs, "h": h, "hq": hq, "hs": hs})
    return ((x.float() + b2.float()) + part).to(x.dtype)


def attention_block_q_attr_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale, bo,
                                 *, heads: int, mode: str,
                                 scratch: Optional[dict] = None) -> torch.Tensor:
    """``attn_kernel`` of benchmarks/q_attribution.py.  "full": K3 (no
    causal mask).  "mxu": qkv = bf16(dot_q(static_q(x)) + bqkv),
    ``attention_core_nosoftmax``, the attention rows' codes ``unit_q``, out
    = x + (dot_q(those codes) + bo).  "vpu": LN and quant_rows; qkv =
    bf16(bcast_rows(x codes) + bqkv), ``attention_core_vpu``,
    quant_rows(attn), out = x + (bcast_rows(attn codes) + bo)."""
    _check_attr_mode(mode)
    if mode == "full":
        return attention_block_q_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q,
                                       wo_scale, bo, heads=heads, scratch=scratch)
    dt, d = x.dtype, x.shape[-1]
    rows = {}
    if mode == "mxu":
        xq, xs = static_q(x)
        qkv = (dot_q(xq, xs, wqkv_q, wqkv_scale) + bqkv.float()).to(dt)
        attn = attention_core_nosoftmax(qkv, heads).float()
        aq, ascale = unit_q(attn)
        proj = dot_q(aq, ascale, wo_q, wo_scale) + bo.float()
    else:
        rows["xn"] = ln_f32(x, ln_s, ln_b).float()
        xq, xs = quant_rows(rows["xn"])
        qkv = (bcast_rows(xq, xs, 3 * d) + bqkv.float()).to(dt)
        attn = attention_core_vpu(qkv, heads).float()
        aq, ascale = quant_rows(attn)
        proj = bcast_rows(aq, ascale, d) + bo.float()
    if scratch is not None:
        scratch.update({**rows, "xq": xq, "xs": xs, "attn": attn, "aq": aq, "as": ascale})
    return (x.float() + proj).to(dt)


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
        lib.dvl_attention_block_q.argtypes = [p] * 17 + [i] * 6 + [ctypes.c_float, p]
        lib.dvl_attention_block_q.restype = i
        lib.dvl_mlp_block_q.argtypes = [p] * 16 + [i] * 6 + [p]
        lib.dvl_mlp_block_q.restype = i
        f = ctypes.c_float
        for entry in ("dvl_attention_block_q_var", "dvl_attention_block_q_attr_mxu",
                      "dvl_attention_block_q_attr_vpu"):
            getattr(lib, entry).argtypes = [p] * 17 + [i] * 6 + [f, p]
            getattr(lib, entry).restype = i
        lib.dvl_attention_block_q_postdiv.argtypes = [p] * 17 + [i] * 6 + [f, i, p]
        lib.dvl_attention_block_q_postdiv.restype = i
        lib.dvl_attention_block_qq.argtypes = [p] * 18 + [i] * 6 + [f, p]
        lib.dvl_attention_block_qq.restype = i
        lib.dvl_attention_qq_core.argtypes = [p] * 6 + [i] * 4 + [f, p]
        lib.dvl_attention_qq_core.restype = i
        lib.dvl_qq_ws_bytes.argtypes = [i] * 4
        lib.dvl_qq_ws_bytes.restype = ctypes.c_longlong
        lib.dvl_mlp_block_q_kb.argtypes = [p] * 17 + [i] * 6 + [p]
        lib.dvl_mlp_block_q_kb.restype = i
        lib.dvl_fused_layer_q.argtypes = [p] * 31 + [i] * 6 + [f, i, p]
        lib.dvl_fused_layer_q.restype = i
        lib.dvl_layer_down_fits.argtypes = [i]
        lib.dvl_layer_down_fits.restype = i
        lib.dvl_fsplit_down_fits.argtypes = [i, i]
        lib.dvl_fsplit_down_fits.restype = i
        lib.dvl_attention_block_q_heads.argtypes = [p] * 11 + [i] * 6 + [f, p]
        lib.dvl_attention_block_q_heads.restype = i
        lib.dvl_mlp_block_q_cols.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.dvl_mlp_block_q_cols.restype = i
        lib.dvl_rows_q_partial.argtypes = [p, i, p, i, p, p, p, p, i, i, i, i, i, p]
        lib.dvl_rows_q_partial.restype = i
        lib.dvl_rows_strip_fits.argtypes = [i, i]
        lib.dvl_rows_strip_fits.restype = i
        lib.dvl_tp_reduce_q.argtypes = [p, i, p, p, p, p, p, i, i, i, p]
        lib.dvl_tp_reduce_q.restype = i
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


# the int8 attention block's C entries by variant: K3, KB (a) 1, KB (a) 4,
# q_ilp4.py's post-P V division and q_attribution.py's "mxu" and "vpu"
# bodies, with their KB_LAUNCHES keys
_ATTN_Q_ENTRIES = {"k3": "dvl_attention_block_q", "qq": "dvl_attention_block_qq",
                   "var": "dvl_attention_block_q_var",
                   "postdiv": "dvl_attention_block_q_postdiv",
                   "attr_mxu": "dvl_attention_block_q_attr_mxu",
                   "attr_vpu": "dvl_attention_block_q_attr_vpu"}
_ATTN_Q_COUNTERS = {"qq": "attention_block_qq", "var": "attention_block_q_var",
                    "postdiv": "attention_block_q_postdiv",
                    "attr_mxu": "attention_block_q_attr_mxu",
                    "attr_vpu": "attention_block_q_attr_vpu"}


def _q_attn_kernel_ops(wqkv_qt, wqkv_scale, bqkv, wo_qt, wo_scale, bo, plan: AttnPlan, dev):
    """K3's weights, scales and biases as the kernel reads them: the plain
    ``[out, in]`` copies where the plan is the identity, else
    ``q_attn_operands``'s."""
    d, f32 = plan.d, torch.float32
    ops = (*_qweight(wqkv_qt, wqkv_scale, d, 3 * d, "wqkv", dev),
           _operand(bqkv, f32, (3 * d,), "bqkv", dev),
           *_qweight(wo_qt, wo_scale, d, d, "wo", dev), _operand(bo, f32, (d,), "bo", dev))
    if plan.identity:
        return ops
    return planned((wqkv_qt, wqkv_scale, bqkv, wo_qt, wo_scale, bo), ("attn_q", plan),
                   lambda: q_attn_operands(ops[0], ops[1], ops[2], ops[3], ops[4], ops[5], plan))


def _q_mlp_kernel_ops(w1_qt, w1_scale, b1, w2_qt, w2_scale, b2, plan: MlpPlan, dev):
    """K4's weights, scales and biases as the kernel reads them
    (``q_mlp_operands`` off the identity)."""
    d, f, f32 = plan.d, plan.f, torch.float32
    ops = (*_qweight(w1_qt, w1_scale, d, f, "w1", dev), _operand(b1, f32, (f,), "b1", dev),
           *_qweight(w2_qt, w2_scale, f, d, "w2", dev), _operand(b2, f32, (d,), "b2", dev))
    if plan.identity:
        return ops
    return planned((w1_qt, w1_scale, b1, w2_qt, w2_scale, b2), ("mlp_q", plan),
                   lambda: q_mlp_operands(*ops, plan))


def _qq_workspace(b, s, heads, hdp, device):
    """The int8 core's workspace (both routes: the codes and scales of its
    quantize launches): ``dvl_qq_ws_bytes`` bytes, 256-byte aligned."""
    n = _lib().dvl_qq_ws_bytes(b, s, heads, hdp)
    ws = torch.empty((n,), dtype=torch.uint8, device=device)
    if ws.data_ptr() % 256:
        raise RuntimeError("the int8 core's workspace is not 256-byte aligned")
    return ws


def _attention_block_q_cuda(x, ln_s, ln_b, wqkv_scale, bqkv, wo_scale, bo,
                            heads, causal, wqkv_qt, wo_qt, scratch, kind="k3", tma=True):
    """K3's launch on ``attn_plan``'s layout (any D and head dim), or a KB
    variant's on the same layout.  q_ilp4's ("postdiv") normalises and
    quantizes x in one pass (no LayerNorm rows in the scratch), runs its
    QKV product on the persistent TMA-store GEMM and the core's
    divide-after instantiation; ``tma=False`` runs K3's launches, the same
    outputs bit for bit, for the checks."""
    _check_x(x)
    b, s, d = x.shape
    if s < 1:
        raise ValueError(f"sequence length {s} < 1")
    plan = attn_plan(d, heads)
    dev = x.device
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    ops = [_operand(ln_s, f32, (d,), "ln_scale", dev),
           _operand(ln_b, f32, (d,), "ln_bias", dev),
           *_q_attn_kernel_ops(wqkv_qt, wqkv_scale, bqkv, wo_qt, wo_scale, bo, plan, dev)]
    m = b * s
    out = torch.empty_like(x)
    tma = tma and kind == "postdiv"
    xn = None if tma else torch.empty((m, plan.dk), dtype=bf, device=dev)
    xq = torch.empty((m, plan.dk), dtype=i8, device=dev)
    xs = torch.empty((m,), dtype=f32, device=dev)
    qkv = torch.empty((m, plan.nqkv), dtype=f32 if kind == "qq" else bf, device=dev)
    attn = torch.empty((m, plan.da), dtype=bf, device=dev)
    aq = torch.empty((m, plan.da), dtype=i8, device=dev)
    ascale = torch.empty((m,), dtype=f32, device=dev)
    entry = _ATTN_Q_ENTRIES[kind]
    ptrs = [x.data_ptr(), *[t.data_ptr() for t in ops], out.data_ptr(),
            0 if xn is None else xn.data_ptr(), xq.data_ptr(), xs.data_ptr(), qkv.data_ptr(),
            attn.data_ptr(), aq.data_ptr(), ascale.data_ptr()]
    if kind == "qq":
        ws = _qq_workspace(b, s, heads, plan.hdp, dev)
        ptrs.append(ws.data_ptr())
    dims = [b, s, d, heads, plan.hdp, int(causal), plan.scale]
    if kind == "postdiv":
        dims.append(int(tma))
    err = getattr(_lib(), entry)(*ptrs, *dims, _stream_ptr(dev))
    _raise_on(err, entry)
    if kind == "k3":
        LAUNCHES["attention_block_q_causal" if causal else "attention_block_q"] += 1
        CORE_ROUTES[core_route(s, plan.hd)] += 1
    else:
        KB_LAUNCHES[_ATTN_Q_COUNTERS[kind]] += 1
        if kind == "qq":  # the block's launch runs the int8 core once
            KB_LAUNCHES["attention_qq_core"] += 1
            QQ_ROUTES[qq_route(s, plan.hd)] += 1
        if kind == "postdiv":
            POSTDIV_ROUTES["tma" if tma else "gemm"] += 1
        if kind in ("var", "postdiv", "attr_mxu"):  # K3's wgmma core
            # the register core's softmax-off mode is hdp 64's: wider heads
            # take the long core
            wide_off = kind == "attr_mxu" and plan.hdp > 64
            CORE_ROUTES["long" if wide_off else core_route(s, plan.hd)] += 1
    check_nans(entry, out)
    if scratch is not None:  # the model's widths: the padded lanes cropped
        crop = plan.crop_heads
        scratch.update({"xq": xq[:, :d].reshape(b, s, d), "xs": xs.view(b, s, 1),
                        "attn": crop(attn).reshape(b, s, d).float(),
                        "aq": crop(aq).reshape(b, s, d), "as": ascale.view(b, s, 1)})
        # LayerNorm's rows, where a launch of their own wrote them ("mxu"
        # has no LayerNorm: x's codes are its static cast)
        if xn is not None and kind != "attr_mxu":
            scratch["xn"] = xn[:, :d].reshape(b, s, d).float()
        if kind == "qq":
            scratch["qkv"] = qkv[:, plan.qkv_columns().to(dev)].view(b, s, 3 * d)
    return out


def _attention_qq_core_cuda(qkv32, heads, scratch):
    b, s, d3 = qkv32.shape
    d = d3 // 3
    if s < 1:
        raise ValueError(f"sequence length {s} < 1")
    if qkv32.dtype != torch.float32:
        raise ValueError(f"the CUDA int8 attention core reads a float32 qkv, got {qkv32.dtype}")
    plan = attn_plan(d, heads)
    dev = qkv32.device
    # the core reads each head at hdp lanes (zero past hd): the model's own
    # layout at head dim 64, else the padded copy
    rows = qkv32.reshape(b * s, d3)
    if plan.hd != plan.hdp:
        rows = place(rows, (b * s, 3 * plan.da), cols=plan.qkv_columns())
    rows = rows.contiguous()
    out = torch.empty((b, s, plan.da), dtype=torch.bfloat16, device=dev)
    p = pq = psc = None
    if scratch is not None:
        p = torch.empty((b, heads, s, s), dtype=torch.float32, device=dev)
        pq = torch.empty((b, heads, s, s), dtype=torch.int8, device=dev)
        psc = torch.empty((b, heads, s, 1), dtype=torch.float32, device=dev)
    ws = _qq_workspace(b, s, heads, plan.hdp, dev)
    err = _lib().dvl_attention_qq_core(
        rows.data_ptr(), out.data_ptr(),
        *[None if t is None else t.data_ptr() for t in (p, pq, psc)], ws.data_ptr(),
        b, s, heads, plan.hdp, plan.scale, _stream_ptr(dev))
    _raise_on(err, "dvl_attention_qq_core")
    KB_LAUNCHES["attention_qq_core"] += 1
    QQ_ROUTES[qq_route(s, plan.hd)] += 1
    out = plan.crop_heads(out) if plan.hd != plan.hdp else out
    check_nans("dvl_attention_qq_core", out)
    if scratch is not None:
        scratch.update({"p": p, "pq": pq, "psc": psc})
    return out


# K4 and its KB variants: the C entry's hidden / quantizer mode and the
# launch counter (``mlp_block_q_kb``'s modes, csrc/fused_block_q.cu;
# KB_LAUNCHES["mlp_block_q_" + kind])
_MLP_Q_MODES = {"k4": 0, "bf16h": 1, "var": 2, "var_bf16_gelu": 3, "attr_mxu": 4, "attr_vpu": 5}


@functools.lru_cache(maxsize=None)
def fsplit_route(d: int, fb: int) -> str:
    """The route of K4's F-split on the card at model width ``d`` and F-tile
    ``fb``: "epi" (the down product on the epilogue-warpgroup GEMM) where
    the library's rule takes it (csrc/fused_block_q.cu::fsplit_down_fits:
    d % 8 == 0, its bf16 rows whole 16-byte units, and each chunk, fb
    padded to a multiple of 128, whole K steps), else "gemm" (the chunked s8
    GEMM).  Needs the library."""
    return "epi" if _lib().dvl_fsplit_down_fits(d, round_up(fb, S8_GEMM_TILE)) else "gemm"


def _mlp_block_q_cuda(x, ln_s, ln_b, w1_scale, b1, w2_scale, b2, act_kind,
                      w1_qt, w2_qt, scratch, kind="k4", fb=None, tma=True):
    """K4's launch on ``mlp_plan``'s layout (any D, F and divisor fb of F),
    or a KB variant's on the same layout (fb = F).  The F-split, bf16h and
    KB (a) 3 normalise and quantize x in one pass (no LayerNorm rows in the
    scratch) and take their routes (``fsplit_route``; bf16h's up product on
    the persistent GEMM); ``tma=False`` runs the launches before those
    designs, the same outputs bit for bit, for the checks."""
    _check_x(x)
    b, s, d = x.shape
    f = w1_scale.numel()
    fb = check_fb(f, fb)
    plan = mlp_plan(d, f, fb)
    k = plan.k
    dev = x.device
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    ops = [_operand(ln_s, f32, (d,), "ln_scale", dev),
           _operand(ln_b, f32, (d,), "ln_bias", dev),
           *_q_mlp_kernel_ops(w1_qt, w1_scale, b1, w2_qt, w2_scale, b2, plan, dev)]
    m = b * s
    out = torch.empty_like(x)
    var = kind in ("var", "var_bf16_gelu")
    ln_quant = k > 1 or kind == "bf16h" or (var and tma)  # LayerNorm's rows never written
    xn = None if ln_quant else torch.empty((m, plan.dk), dtype=bf, device=dev)
    xq = torch.empty((m, plan.dk), dtype=i8, device=dev)
    xs = torch.empty((m,), dtype=f32, device=dev)
    # bf16h keeps the pre-activation in bf16; the quantize pass applies
    # quick_gelu (and, given the scratch, writes its f32 result to g);
    # attr_mxu's up GEMM writes the int8 hidden itself, and no h
    h = None if kind == "attr_mxu" else \
        torch.empty((m, plan.fp), dtype=bf if kind == "bf16h" else f32, device=dev)
    g = torch.empty((m, plan.fp), dtype=f32, device=dev) \
        if kind == "bf16h" and scratch is not None else None
    hq = torch.empty((m, plan.fp), dtype=i8, device=dev)
    hs = torch.empty((m, k), dtype=f32, device=dev)
    ptrs = [x.data_ptr(), *[t.data_ptr() for t in ops], out.data_ptr(),
            0 if xn is None else xn.data_ptr(), xq.data_ptr(), xs.data_ptr(),
            0 if h is None else h.data_ptr(), hq.data_ptr(), hs.data_ptr()]
    if kind == "k4":
        err = _lib().dvl_mlp_block_q(*ptrs, int(tma), m, d, plan.fp, ACT_KINDS.index(act_kind),
                                     k, _stream_ptr(dev))
        _raise_on(err, "dvl_mlp_block_q")
        if k > 1:
            KB_LAUNCHES["mlp_block_q_fsplit"] += 1
            FSPLIT_ROUTES[fsplit_route(d, fb) if tma else "gemm"] += 1
        else:
            LAUNCHES["mlp_block_q"] += 1
    else:
        err = _lib().dvl_mlp_block_q_kb(*ptrs, 0 if g is None else g.data_ptr(), m, d, plan.fp,
                                        f, _MLP_Q_MODES[kind], int(tma), _stream_ptr(dev))
        _raise_on(err, "dvl_mlp_block_q_kb")
        KB_LAUNCHES["mlp_block_q_" + kind] += 1
        if kind == "bf16h":
            BF16H_ROUTES["tma" if tma else "gemm"] += 1
        if var:
            VAR_ROUTES["ln" if tma else "gemm"] += 1
    check_nans("dvl_mlp_block_q", out)
    if scratch is not None:  # the model's widths: the padded lanes cropped
        rows = (b, s, f) if k == 1 else (b, s, k, fb)
        crop = plan.crop_hidden
        scratch.update({"xq": xq[:, :d].reshape(b, s, d), "xs": xs.view(b, s, 1),
                        "hq": crop(hq).reshape(rows), "hs": hs.view(*rows[:-1], 1)})
        if kind != "attr_mxu":  # no LayerNorm and no f32 hidden there
            scratch["h"] = crop(h if g is None else g).reshape(rows)
            if xn is not None:  # LayerNorm's rows, where a launch of their own wrote them
                scratch["xn"] = xn[:, :d].reshape(b, s, d).float()
        if kind == "bf16h":
            scratch["u"] = crop(h).view(b, s, f)
    return out


@functools.lru_cache(maxsize=None)
def layer_route(d: int) -> str:
    """The route of ``fused_layer_q`` on the card at model width ``d``: "tma"
    (the QKV product on the persistent TMA-store GEMM, the down product on
    the epilogue-warpgroup GEMM) where the library's rule takes the down
    product (csrc/fused_block_q.cu::layer_down_fits: d % 8 == 0, its bf16
    and f32 rows whole 16-byte units), else "qkv" (the QKV product alone;
    the down product on the s8 GEMM).  Needs the library."""
    return "tma" if _lib().dvl_layer_down_fits(d) else "qkv"


def _fused_layer_q_cuda(x, attn_ops, mlp_ops, heads, scratch, tma=True):
    """``dvl_fused_layer_q``: ``attn_ops`` / ``mlp_ops`` are the two halves'
    parameters as K3's / K4's wrappers pass them (LN, weight copies,
    scales, biases), on K3's and K4's padded layouts, on ``layer_route``
    (``tma=False``: every product on the s8 GEMM, the same outputs bit for
    bit, for the checks)."""
    _check_x(x)
    b, s, d = x.shape
    if s < 1:
        raise ValueError(f"sequence length {s} < 1")
    (ln1_s, ln1_b, wqkv_scale, bqkv, wo_scale, bo, wqkv_qt, wo_qt) = attn_ops
    (ln2_s, ln2_b, w1_scale, b1, w2_scale, b2, w1_qt, w2_qt) = mlp_ops
    f = w1_scale.numel()
    ap, mp = attn_plan(d, heads), mlp_plan(d, f)
    dev = x.device
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    ops = [_operand(ln1_s, f32, (d,), "ln_1.scale", dev),
           _operand(ln1_b, f32, (d,), "ln_1.bias", dev),
           *_q_attn_kernel_ops(wqkv_qt, wqkv_scale, bqkv, wo_qt, wo_scale, bo, ap, dev),
           _operand(ln2_s, f32, (d,), "ln_2.scale", dev),
           _operand(ln2_b, f32, (d,), "ln_2.bias", dev),
           *_q_mlp_kernel_ops(w1_qt, w1_scale, b1, w2_qt, w2_scale, b2, mp, dev)]
    m = b * s
    out = torch.empty_like(x)
    t = {"xq": (m, ap.dk, i8), "xs": (m, 1, f32), "qkv": (m, ap.nqkv, bf),
         "attn": (m, ap.da, bf), "aq": (m, ap.da, i8), "as": (m, 1, f32), "y": (m, d, f32),
         "yb": (m, d, bf), "yq": (m, mp.dk, i8), "ys": (m, 1, f32),
         "h": (m, mp.fp, f32), "hq": (m, mp.fp, i8), "hs": (m, 1, f32)}
    t = {k: torch.empty(v[:2], dtype=v[2], device=dev) for k, v in t.items()}
    route = layer_route(d) if tma else "gemm"
    err = _lib().dvl_fused_layer_q(
        x.data_ptr(), *[o.data_ptr() for o in ops], out.data_ptr(),
        *[t[k].data_ptr() for k in ("xq", "xs", "qkv", "attn", "aq", "as", "y", "yb", "yq",
                                    "ys", "h", "hq", "hs")],
        b, s, d, mp.fp, heads, ap.hdp, ap.scale, int(tma),
        _stream_ptr(dev))
    _raise_on(err, "dvl_fused_layer_q")
    KB_LAUNCHES["fused_layer_q"] += 1
    LAYER_ROUTES[route] += 1
    CORE_ROUTES[core_route(s, ap.hd)] += 1
    check_nans("dvl_fused_layer_q", out)
    if scratch is not None:  # the twin's keys: bf16 rows as f32, codes, scales, cropped
        crop = {"xq": lambda v: v[:, :d], "yq": lambda v: v[:, :d], "attn": ap.crop_heads,
                "aq": ap.crop_heads, "h": mp.crop_hidden, "hq": mp.crop_hidden}
        for k, v in t.items():
            if k == "qkv":
                continue
            v = crop.get(k, lambda r: r)(v).reshape(b, s, -1)
            scratch[k] = v.float() if v.dtype == bf and k != "yb" else v
    return out


def _q_slot_ops(ln_s, ln_b, qt, scale, bias, name, plan, shape, rows, device):
    """A slot's LayerNorm parameters and int8 weight as the slot kernel reads
    them: the weight's [out, in] copy, channel scales and biases placed at
    ``rows()`` of zeros of ``shape`` (``plan``'s padded layout; as they are
    where that is their own shape), kept per version of every one of them:
    a call past the first checks, casts and copies nothing."""
    d, n, f32 = plan.d, scale.numel(), torch.float32

    def build():
        ops = (_operand(ln_s, f32, (d,), "ln_scale", device),
               _operand(ln_b, f32, (d,), "ln_bias", device),
               *_qweight(qt, scale, d, n, name, device),
               _operand(bias, f32, (n,), "b" + name[1:], device))
        if shape == (n, d):
            return ops
        at = rows()
        return (*ops[:2], place(ops[2], shape, rows=at), place(ops[3], shape[:1], rows=at),
                place(ops[4], shape[:1], rows=at))

    return planned((qt, scale, bias, ln_s, ln_b), (name, plan), build)


def _attention_q_heads_cuda(x, ln_s, ln_b, wqkv_scale, bqkv, g, causal, wqkv_qt):
    _check_x(x)
    b, s, d = x.shape
    if s < 1:
        raise ValueError(f"sequence length {s} < 1")
    plan = group_plan(d, wqkv_scale.numel() // (3 * g), g)
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    ops = _q_slot_ops(ln_s, ln_b, wqkv_qt, wqkv_scale, bqkv, "wqkv", plan, (plan.nqkv, plan.dk),
                      plan.qkv_columns, dev)
    m = b * s
    xq = torch.empty((m, plan.dk), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=f32, device=dev)
    qkv = torch.empty((m, plan.nqkv), dtype=bf, device=dev)
    attn = torch.empty((b, s, plan.da), dtype=bf, device=dev)
    amax = torch.empty((b, s, 1), dtype=f32, device=dev)
    err = _lib().dvl_attention_block_q_heads(
        x.data_ptr(), *[t.data_ptr() for t in ops], xq.data_ptr(), xs.data_ptr(),
        qkv.data_ptr(), attn.data_ptr(), amax.data_ptr(), b, s, d, g, plan.hdp, int(causal),
        plan.scale, _stream_ptr(dev))
    _raise_on(err, "dvl_attention_block_q_heads")
    TP_LAUNCHES["attention_block_q_heads_causal" if causal else "attention_block_q_heads"] += 1
    CORE_ROUTES[core_route(s, plan.hd)] += 1
    check_nans("dvl_attention_block_q_heads", attn)
    return attn, amax


def _mlp_q_cols_cuda(x, ln_s, ln_b, w1_scale, b1, act_kind, w1_qt):
    _check_x(x)
    b, s, d = x.shape
    plan = mlp_plan(d, w1_scale.numel())
    dev = x.device
    f32 = torch.float32
    ops = _q_slot_ops(ln_s, ln_b, w1_qt, w1_scale, b1, "w1", plan, (plan.fp, plan.dk),
                      plan.hidden_columns, dev)
    m = b * s
    xq = torch.empty((m, plan.dk), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=f32, device=dev)
    h = torch.empty((b, s, plan.fp), dtype=f32, device=dev)
    amax = torch.empty((b, s, 1), dtype=f32, device=dev)  # zeroed by the kernel
    err = _lib().dvl_mlp_block_q_cols(
        x.data_ptr(), *[t.data_ptr() for t in ops], xq.data_ptr(), xs.data_ptr(), h.data_ptr(),
        amax.data_ptr(), m, d, plan.fp, ACT_KINDS.index(act_kind), _stream_ptr(dev))
    _raise_on(err, "dvl_mlp_block_q_cols")
    TP_LAUNCHES["mlp_block_q_cols"] += 1
    check_nans("dvl_mlp_block_q_cols", h)
    return h, amax


@functools.lru_cache(maxsize=None)
def rows_route(k: int, n: int) -> str:
    """The route of ``rows_q_partial`` on the card for K code columns (the
    input's width padded to 16) into int32 rows of N: "strip" (one launch
    of the row-strip kernel) where the library's rule takes it
    (csrc/fused_block_q.cu::rows_strip_fits: K a multiple of 64 up to 384,
    N % 4 == 0), else "gemm" (the quantize pass, then the s8 GEMM).  Needs
    the library."""
    return "strip" if _lib().dvl_rows_strip_fits(k, n) else "gemm"


def _rows_q_partial_cuda(a, amaxes, w_qt, plan, strip=True):
    """The quantize at the maxed amaxes and the int8 product, on
    ``rows_route`` (``strip=False``: the quantize pass and the s8 GEMM, for
    the checks): ``a``'s rows in ``plan``'s padded layout when wider than
    the weight's K rows (a slot's kernel output off the identity), the
    weight copy laid out to match (its rows at the plan's lanes, N rounded
    up to the GEMM's tile; the store keeps the first N columns)."""
    dev = a.device
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rows_q_partial takes a bf16 or f32 input, got {a.dtype}")
    check_parts(len(amaxes), "rows_q_partial")
    n, kw = w_qt.shape
    k = a.shape[-1]
    lanes = None
    if k != kw:
        if plan is None:
            raise ValueError(f"rows_q_partial: a has {k} columns, the weight {kw} rows; pass "
                             f"the plan of a's layout")
        lanes = plan.head_lanes() if isinstance(plan, AttnPlan) else plan.hidden_columns()
    kp = round_up(k, 16)  # the TMA's 16-byte row stride
    a = pad_cols(a, kp).contiguous()
    if a.data_ptr() % 16:  # the kernels' 16-byte loads
        a = a.clone()
    m = a.numel() // kp
    no = round_up(n, S8_GEMM_TILE)
    wt = _operand(w_qt, torch.int8, (n, kw), "w_qt", dev)
    if lanes is not None or kp != kw or no != n:
        wt = planned((w_qt,), ("rows", plan, kp, no),
                     lambda: (place(wt, (no, kp), cols=lanes),))[0]
    amaxes = [_operand(t.reshape(-1), torch.float32, (m,), "amax", dev) for t in amaxes]
    aq = torch.empty(a.shape, dtype=torch.int8, device=dev)
    ascale = torch.empty((*a.shape[:-1], 1), dtype=torch.float32, device=dev)
    acc = torch.empty((*a.shape[:-1], n), dtype=torch.int32, device=dev)
    route = rows_route(kp, n) if strip else "gemm"
    ptrs = (ctypes.c_void_p * len(amaxes))(*[t.data_ptr() for t in amaxes])
    err = _lib().dvl_rows_q_partial(a.data_ptr(), int(a.dtype == torch.float32), ptrs,
                                    len(amaxes), wt.data_ptr(), aq.data_ptr(), ascale.data_ptr(),
                                    acc.data_ptr(), m, no, kp, n, int(route == "strip"),
                                    _stream_ptr(dev))
    _raise_on(err, "dvl_rows_q_partial")
    TP_LAUNCHES["rows_q_partial"] += 1
    ROWS_ROUTES[route] += 1
    ROWS_INPUTS["f32" if a.dtype == torch.float32 else "bf16"] += 1
    return acc, aq, ascale


def _tp_reduce_q_cuda(parts, ascale, w_scale, bias, resid, bias_first):
    _check_x(resid)
    dev = resid.device
    n = resid.shape[-1]
    m = resid.numel() // n
    check_parts(len(parts), "tp_reduce_q")
    for t in parts:
        if t.dtype != torch.int32 or t.shape != resid.shape or t.device != dev:
            raise ValueError(f"tp_reduce_q: each partial must be int32 "
                             f"{tuple(resid.shape)} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    ascale = _operand(ascale.reshape(-1), torch.float32, (m,), "ascale", dev)
    w_scale = _operand(w_scale.reshape(-1), torch.float32, (n,), "w_scale", dev)
    bias = _operand(bias, torch.float32, (n,), "bias", dev)
    parts = [t.contiguous() for t in parts]
    out = torch.empty_like(resid)
    ptrs = (ctypes.c_void_p * len(parts))(*[t.data_ptr() for t in parts])
    err = _lib().dvl_tp_reduce_q(ptrs, len(parts), ascale.data_ptr(), w_scale.data_ptr(),
                                 bias.data_ptr(), resid.data_ptr(), out.data_ptr(), m, n,
                                 int(bias_first), _stream_ptr(dev))
    _raise_on(err, "dvl_tp_reduce_q")
    TP_LAUNCHES["tp_reduce_q"] += 1
    check_nans("dvl_tp_reduce_q", out)
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
                act_kind: str = "quick_gelu", fb: Optional[int] = None, w1_qt=None,
                w2_qt=None, scratch: Optional[dict] = None) -> torch.Tensor:
    """x: [B, S, D] -> x + mlp(LN(x)) with int8 up and down products.
    ``fb`` (JAX's F-tile): None or F is K4; a smaller divisor of F
    quantizes each fb-wide chunk of a hidden row on its own and sums the
    chunks' products in f32 (``fsplit_down``; on the card each chunk padded
    to a multiple of 128, counted in ``KB_LAUNCHES["mlp_block_q_fsplit"]``
    and by route in ``FSPLIT_ROUTES``; its scratch has no LayerNorm rows
    there)."""
    if act_kind not in ACT_KINDS:
        raise ValueError(f"act_kind must be one of {ACT_KINDS}, "
                         f"got {act_kind!r}")
    if _route(x) == "cpu":
        return mlp_block_q_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q,
                                 w2_scale, b2, act_kind=act_kind, fb=fb, scratch=scratch)
    return _mlp_block_q_cuda(x, ln_s, ln_b, w1_scale, b1, w2_scale, b2,
                             act_kind, w1_qt, w2_qt, scratch, fb=fb)


def fused_layer_q(x, ln1_s, ln1_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale, bo,
                  ln2_s, ln2_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2, *, heads: int,
                  wqkv_qt=None, wo_qt=None, w1_qt=None, w2_qt=None,
                  scratch: Optional[dict] = None) -> torch.Tensor:
    """The one-call int8 layer of benchmarks/q_layer_fused.py (``tower(bb,
    mode)``, ``layer_kernel``; its three modes are one function): K3's
    nine tensors, then K4's nine.  y = x + proj stays f32 between the
    halves; the MLP's LayerNorm reads bf16(y), its activation is
    quick_gelu (the script's) and the output is (y + b2) + part rounded
    once (``fused_layer_q_plain``).  On a card one call of
    ``dvl_fused_layer_q``, nine launches: LayerNorm and the quantize pass in
    one at both norms (no LayerNorm rows: the scratch has no ``xn`` / ``yn``,
    and holds ``yb``, y's bf16 rounding), the QKV product on the persistent
    TMA-store GEMM, K3's core, the attention rows' quantize pass, the out
    product writing y in f32 and bf16, the up product and the hidden's
    quantize pass, the down product adding the f32 y (on the
    epilogue-warpgroup GEMM where ``layer_route`` takes it), counted in
    ``LAYER_ROUTES``."""
    if _route(x) == "cpu":
        return fused_layer_q_plain(x, ln1_s, ln1_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale,
                                   bo, ln2_s, ln2_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                                   heads=heads, scratch=scratch)
    return _fused_layer_q_cuda(
        x, (ln1_s, ln1_b, wqkv_scale, bqkv, wo_scale, bo, wqkv_qt, wo_qt),
        (ln2_s, ln2_b, w1_scale, b1, w2_scale, b2, w1_qt, w2_qt), heads, scratch)


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


def attention_block_q_heads(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, *, heads: int,
                            causal: bool = False, wqkv_qt=None):
    """A head group's int8 attention up to its row-parallel input
    (``attention_block_q_heads_plain``): (attn, row amax); on a card
    ``wqkv_qt`` is the slice's [3 g hd, D] transpose (made here when None),
    and off head dim 64 or D % 128 == 0 the rows come in the kernels' padded
    layout (``fused_block.group_plan(D, hd, g)``: hdp lanes a head, zeros
    past hd; the same amax), which ``rows_q_partial(plan=)`` reads."""
    if _route(x) == "cpu":
        return attention_block_q_heads_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv,
                                             heads=heads, causal=causal)
    return _attention_q_heads_cuda(x, ln_s, ln_b, wqkv_scale, bqkv, heads, causal,
                                   wqkv_q.t().contiguous() if wqkv_qt is None else wqkv_qt)


def mlp_block_q_cols(x, ln_s, ln_b, w1_q, w1_scale, b1, *, act_kind: str = "quick_gelu",
                     w1_qt=None):
    """A slot's int8 MLP up to its hidden (``mlp_block_q_cols_plain``):
    (f32 hidden columns, row amax); on a card ``w1_qt`` is the columns'
    [F/m, D] transpose (made here when None), and off F/m % 128 == 0 or D %
    128 == 0 the hidden comes in ``fused_block.mlp_plan(D, F/m)``'s padded
    layout (zeros past F/m; the same amax), which ``rows_q_partial(plan=)``
    reads."""
    if act_kind not in ACT_KINDS:
        raise ValueError(f"act_kind must be one of {ACT_KINDS}, got {act_kind!r}")
    if _route(x) == "cpu":
        return mlp_block_q_cols_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, act_kind=act_kind)
    return _mlp_q_cols_cuda(x, ln_s, ln_b, w1_scale, b1, act_kind,
                            w1_q.t().contiguous() if w1_qt is None else w1_qt)


def rows_q_partial(a, amaxes, w_q, *, w_qt=None, plan=None):
    """``rows_q_partial_plain``: (int32 partial, codes, row scales); on a card
    ``w_qt`` is the weight rows' [N, K] transpose (``QWeight.qt``) and
    ``plan`` the padded layout of ``a``'s rows where they are wider than K
    (``group_plan`` / ``mlp_plan``: a slot's kernel output off the
    identity); the codes then are at the padded width."""
    if _route(a) == "cpu":
        return rows_q_partial_plain(a, amaxes, w_q)
    return _rows_q_partial_cuda(a, amaxes, w_q.t().contiguous() if w_qt is None else w_qt, plan)


def tp_reduce_q(parts, ascale, w_scale, bias, resid, *, bias_first: bool):
    """``tp_reduce_q_plain``: the exact int32 sum of the slots' partials (on
    resid's device), dequantized once, + bias + resid."""
    if _route(resid) == "cpu":
        return tp_reduce_q_plain(parts, ascale, w_scale, bias, resid, bias_first=bias_first)
    return _tp_reduce_q_cuda(parts, ascale, w_scale, bias, resid, bias_first)


# ---------------------------------------------------------------------------
# KB (a) 1-4: the int8 kernel experiments
# ---------------------------------------------------------------------------


def attention_qq_core(qkv32: torch.Tensor, heads: int, out_dtype=torch.bfloat16,
                      scratch: Optional[dict] = None) -> torch.Tensor:
    """KB (a) 1's int8 attention core alone (``attention_qq_core_plain``):
    f32 qkv [B, S, 3D] -> [B, S, D]; on a card bf16 out, any head dim and S
    (csrc/attention_qq.cuh, ``qq_route``), ``scratch`` receiving the
    kernel's own p, p codes and p scales."""
    if _route(qkv32) == "cpu":
        return attention_qq_core_plain(qkv32, heads, out_dtype, scratch=scratch)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the CUDA int8 attention core writes bfloat16, got {out_dtype}")
    return _attention_qq_core_cuda(qkv32, heads, scratch)


def attention_block_qq(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale, bo, *,
                       heads: int, wqkv_qt=None, wo_qt=None,
                       scratch: Optional[dict] = None) -> torch.Tensor:
    """KB (a) 1 (``benchmarks/attn_int8_cores.py::attention_block_qq``):
    K3 with qkv kept f32 and the int8 attention core."""
    if _route(x) == "cpu":
        return attention_block_qq_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q,
                                        wo_scale, bo, heads=heads, scratch=scratch)
    return _attention_block_q_cuda(x, ln_s, ln_b, wqkv_scale, bqkv, wo_scale, bo, heads,
                                   False, wqkv_qt, wo_qt, scratch, kind="qq")


def attention_block_q_var(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale, bo, *,
                          heads: int, wqkv_qt=None, wo_qt=None,
                          scratch: Optional[dict] = None) -> torch.Tensor:
    """KB (a) 4 (``make_attn_var`` of benchmarks/q_kernel_variants.py, both
    ``packed``): K3 with the reciprocal quantizer, exp2 and the row sum
    divided out after P V."""
    if _route(x) == "cpu":
        return attention_block_q_var_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q,
                                           wo_scale, bo, heads=heads, scratch=scratch)
    return _attention_block_q_cuda(x, ln_s, ln_b, wqkv_scale, bqkv, wo_scale, bo, heads,
                                   False, wqkv_qt, wo_qt, scratch, kind="var")


def mlp_block_q_bf16h(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2, *,
                      w1_qt=None, w2_qt=None, scratch: Optional[dict] = None) -> torch.Tensor:
    """KB (a) 2 (``tower(bb, depth, bf16h=True)`` of benchmarks/q_mlp_bf16h.py;
    ``bb`` and ``depth`` are the TPU's chain schedule): K4 with the
    pre-activation rounded to bf16 (on the card counted in ``BF16H_ROUTES``
    too; its scratch has no LayerNorm rows there)."""
    if _route(x) == "cpu":
        return mlp_block_q_bf16h_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                                       scratch=scratch)
    return _mlp_block_q_cuda(x, ln_s, ln_b, w1_scale, b1, w2_scale, b2, "quick_gelu",
                             w1_qt, w2_qt, scratch, kind="bf16h")


def mlp_block_q_var(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2, *,
                    bf16_gelu: bool = False, w1_qt=None, w2_qt=None,
                    scratch: Optional[dict] = None) -> torch.Tensor:
    """KB (a) 3 (``make_mlp_var(bf16_gelu)`` of benchmarks/
    q_kernel_variants.py): K4 with the reciprocal quantizer, quick_gelu in
    f32 or bf16 (on the card counted in ``VAR_ROUTES`` too; its scratch has
    no LayerNorm rows there)."""
    if _route(x) == "cpu":
        return mlp_block_q_var_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                                     bf16_gelu=bf16_gelu, scratch=scratch)
    return _mlp_block_q_cuda(x, ln_s, ln_b, w1_scale, b1, w2_scale, b2, "quick_gelu",
                             w1_qt, w2_qt, scratch,
                             kind="var_bf16_gelu" if bf16_gelu else "var")


def mlp_block_q_attr(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2, *, mode: str,
                     w1_qt=None, w2_qt=None, scratch: Optional[dict] = None) -> torch.Tensor:
    """``make_mlp(mode)`` of benchmarks/q_attribution.py (``mlp_kernel``;
    ``mlp_block_q_attr_plain``): "full" is K4 (its launch, counted in
    ``LAUNCHES``), "mxu" and "vpu" K4's launch sequence with one side
    stubbed out (``KB_LAUNCHES["mlp_block_q_attr_" + mode]``).  The "mxu"
    scratch has no xn and no h: the up GEMM writes the int8 hidden."""
    _check_attr_mode(mode)
    if mode == "full":
        return mlp_block_q(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2, w1_qt=w1_qt,
                           w2_qt=w2_qt, scratch=scratch)
    if _route(x) == "cpu":
        return mlp_block_q_attr_plain(x, ln_s, ln_b, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                                      mode=mode, scratch=scratch)
    return _mlp_block_q_cuda(x, ln_s, ln_b, w1_scale, b1, w2_scale, b2, "quick_gelu", w1_qt,
                             w2_qt, scratch, kind="attr_" + mode)


def attention_block_q_attr(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale, bo, *,
                           heads: int, mode: str, wqkv_qt=None, wo_qt=None,
                           scratch: Optional[dict] = None) -> torch.Tensor:
    """``make_attn(mode)`` of benchmarks/q_attribution.py (``attn_kernel``;
    ``attention_block_q_attr_plain``): "full" is K3 (its launch, counted in
    ``LAUNCHES``), "mxu" and "vpu" K3's launch sequence with one side
    stubbed out (``KB_LAUNCHES["attention_block_q_attr_" + mode]``), at any
    S: the "mxu" core takes K3's short and long routes with its softmax
    off.  The "mxu" scratch has no xn."""
    _check_attr_mode(mode)
    if mode == "full":
        return attention_block_q(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale, bo,
                                 heads=heads, wqkv_qt=wqkv_qt, wo_qt=wo_qt, scratch=scratch)
    if _route(x) == "cpu":
        return attention_block_q_attr_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q,
                                            wo_scale, bo, heads=heads, mode=mode,
                                            scratch=scratch)
    return _attention_block_q_cuda(x, ln_s, ln_b, wqkv_scale, bqkv, wo_scale, bo, heads, False,
                                   wqkv_qt, wo_qt, scratch, kind="attr_" + mode)


def attention_block_q_postdiv(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q, wo_scale, bo, *,
                              heads: int, wqkv_qt=None, wo_qt=None,
                              scratch: Optional[dict] = None) -> torch.Tensor:
    """The head-pair packed int8 attention of benchmarks/q_ilp4.py
    (``make_call(bb)``; ``bb`` and the packing are the TPU's issue order):
    K3 with the row sum divided out after P V
    (``attention_block_q_postdiv_plain``); on a card LayerNorm and
    quantize in one pass, the QKV product on the persistent TMA-store GEMM
    and the core's divide-after instantiation (counted in
    ``POSTDIV_ROUTES``; its scratch has no LayerNorm rows)."""
    if _route(x) == "cpu":
        return attention_block_q_postdiv_plain(x, ln_s, ln_b, wqkv_q, wqkv_scale, bqkv, wo_q,
                                               wo_scale, bo, heads=heads, scratch=scratch)
    return _attention_block_q_cuda(x, ln_s, ln_b, wqkv_scale, bqkv, wo_scale, bo, heads,
                                   False, wqkv_qt, wo_qt, scratch, kind="postdiv")
