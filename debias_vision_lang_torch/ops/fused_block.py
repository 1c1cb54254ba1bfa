"""Fused transformer-block entry points: a hand-written CUDA kernel for each,
and the plain PyTorch twin that specifies its math.

Counterpart of ``debias_vision_lang_tpu/ops/fused_block.py``:

  attention_block:  out = x + (MHA(LN1(x)) @ Wo + bo)
  mlp_block:        out = x + b2 + act(LN2(x) @ W1 + b1) @ W2

Each wrapper takes the tensor's device as the route: a CPU tensor runs the
plain twin, a CUDA tensor launches the kernel (``csrc/fused_block.cu``) or
raises -- nothing falls back.  The twins round exactly where the TPU
kernels round (``_kernel_math_resblock`` is their common specification):
f32 LayerNorm rounded to the input dtype, f32-accumulated products, qkv /
probabilities / per-head outputs / MLP hidden rounded to the input dtype,
an f32 softmax normalised before PV, f32 residual adds with one rounding.
At float32 every rounding is the identity, so the twins are the fp32
reference math too.

``LAUNCHES`` counts kernel launches (CPU twins never count), so a run can
show that its main path went through the kernels; ``CORE_ROUTES`` counts
the attention block's launches by the route its core took (``core_route``:
the register core up to 320 keys at head dims up to 128, the two-pass long
route otherwise, both in ``csrc/attention_wgmma.cuh``).

The kernels take any D, head dim and F (as the TPU kernels do): the
wrappers lay the weights out on a padded operand layout (``attn_plan`` /
``mlp_plan``: each head's q, k, v zero-padded to a multiple of 64 lanes,
the GEMMs' N to 128 and K to 64, the hidden's F-chunks to 128; zero
weights, biases and scales, so every padded lane stays 0 and the scores
keep the true head dim's scale), kept per parameter version as the K-major
copies are.  At the registry archs' widths (head dim 64, D % 128 == 0) the
plan is the identity and the kernels read the plain copies.
``attention_block_padded`` / ``mlp_block_padded`` run the twins on that
layout (the kernels' data flow on the CPU).

``fused_resblock_diff`` / ``fused_transformer_diff`` make the blocks
differentiable (as ``_fused_resblock_diff``, a custom VJP in the JAX
package): the forward is the two entry points above -- the kernels on a
CUDA tensor -- and the backward recomputes the block through the plain
twins, the kernels' own math, and differentiates that.

The split entries (``parallel/tensor.py`` runs them; ``TP_LAUNCHES``
counts them):

  attention_block_heads:  a head group's f32 partial, attn_g @ Wo[rows_g]
  attention_block_hgrid:  KB (a) 6 (benchmarks/attn_variants.py::
                          attention_block_hgrid): K1 from per-head blocks
                          with q pre-scaled by hd^-0.5 log2 e, exp2, the
                          softmax normalised after P @ V, the out-projection
                          summed in f32 across heads; on a head group, its
                          f32 partial
  mlp_block_cols:         act(LN(x) @ W1[:, cols] + b1[cols]) @ W2[cols]
  tp_reduce:              the slots' partials summed in f32, + bias + x,
                          one rounding

All three block entries run one CUDA entry (``dvl_attention_block_heads`` /
``dvl_mlp_block_cols``) on K1 / K2's GEMMs and core, each slot's operands on
a padded layout (``group_plan``: any head dim and any group of heads in a
model of width D; ``mlp_plan`` of its hidden columns), the identity at head
dim 64 and D % 128 == 0.  ``tp_reduce`` sums up to ``TP_PARTS`` partials
in one launch, in slot order.

KB (a) 5 (``KB_LAUNCHES``): ``attention_block_opt`` (benchmarks/
attn_variants.py::attention_block_opt) is K1 with q pre-scaled by hd^-0.5
log2 e (``prescale_qkv``), exp2 and the softmax normalised after P @ V,
then K1's one out-projection over the concatenated heads
(``dvl_attention_block_opt``, on ``attn_plan``'s layout: any D and head
dim).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..models.layers import causal_mask, ln_f32, quick_gelu
from ..utils.observability import check_nans

LAUNCHES: Dict[str, int] = {"attention_block": 0,
                            "attention_block_causal": 0,
                            "mlp_block": 0}
# the split entries' launches (the head-group and column shares of a
# tensor-parallel block, KB (a) 6, the reduce)
TP_LAUNCHES: Dict[str, int] = {"attention_block_heads": 0,
                               "attention_block_heads_causal": 0,
                               "attention_block_hgrid": 0,
                               "mlp_block_cols": 0,
                               "tp_reduce": 0}
KB_LAUNCHES: Dict[str, int] = {"attention_block_opt": 0}
TP_PARTS = 256  # partials one reduce launch sums (the kernels' pointer arrays)
LOG2E = math.log2(math.e)
ACT_KINDS = ("quick_gelu", "gelu")
MAX_SEQ = 320  # keys per score row the CUDA attention core holds in registers
MAX_SHORT_HDP = 128  # padded head dims the register core holds (hdp 64 and 128)
CORE_ROUTES: Dict[str, int] = {"short": 0, "long": 0}
GEMM_N, GEMM_K = 128, 64  # the CUDA GEMM's block width and K step: the layout's N, K edges


def reset_launches() -> None:
    for counts in (LAUNCHES, CORE_ROUTES, TP_LAUNCHES, KB_LAUNCHES):
        for k in counts:
            counts[k] = 0


def core_route(s: int, hd: int = 64) -> str:
    """The route the CUDA attention core of K1 and K3 takes at ``s`` keys
    and head dim ``hd``: "short" (whole score rows in registers) for 1 <= s
    <= MAX_SEQ at a padded head dim (``attn_plan``'s hdp) of at most
    MAX_SHORT_HDP, "long" (two passes over 64-key tiles) otherwise -- the
    choice ``launch_attention_wgmma`` makes."""
    if s < 1:
        raise ValueError(f"sequence length {s} < 1")
    return "short" if s <= MAX_SEQ and round_up(hd, 64) <= MAX_SHORT_HDP else "long"


# ---------------------------------------------------------------------------
# Operand plans: the padded layout the CUDA kernels read
# ---------------------------------------------------------------------------


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class AttnPlan(NamedTuple):
    """The attention block's padded operand layout (csrc/fused_block.cu's
    ``attention_block_impl``, K3 alike): each head's q, k and v zero-padded
    from ``hd`` to ``hdp`` = 64 ceil(hd / 64) lanes (the core's 64-dim
    chunks; the scores keep the true hd^-0.5), LayerNorm's output to ``dk``
    = D rounded up to the GEMM's K step, the qkv row to ``nqkv`` = 3 heads
    hdp rounded up to its 128-column tile, the out-projection's N to ``no``
    = D rounded up to 128 (the store masks the columns past D).  Zero
    weights, biases and scales in the padding keep every padded lane 0: the
    same scores, row amaxes and int8 codes.  ``identity``: the layout is the
    model's own (head dim 64, D % 128 == 0), and the kernels read the
    parameters' plain copies."""
    d: int
    heads: int
    hd: int
    hdp: int
    dk: int
    da: int
    nqkv: int
    no: int

    @property
    def identity(self) -> bool:
        """Head dim 64 and D % 128 == 0: the model's own layout (for a head
        group, up to zero rows that pad the qkv GEMM's N to its tile)."""
        return self.hd == self.hdp and self.no == self.d

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.hd)

    def qkv_columns(self) -> torch.Tensor:
        """Where each of the 3 D q | k | v columns lands in the padded row."""
        i, h, l = torch.meshgrid(torch.arange(3), torch.arange(self.heads),
                                 torch.arange(self.hd), indexing="ij")
        return (i * self.da + h * self.hdp + l).reshape(-1)

    def head_lanes(self) -> torch.Tensor:
        """Where each of the heads x hd attention columns lands in the
        padded row."""
        return self.qkv_columns()[:self.heads * self.hd]

    def crop_heads(self, t: torch.Tensor) -> torch.Tensor:
        """[..., da] padded attention rows -> [..., D]."""
        return t[..., self.head_lanes().to(t.device)]


def attn_plan(d: int, heads: int) -> AttnPlan:
    if heads < 1 or d < 1 or d % heads:
        raise ValueError(f"D={d} is not divisible by heads={heads}")
    return group_plan(d, d // heads, heads)


def group_plan(d: int, hd: int, g: int) -> AttnPlan:
    """The layout of a head group of the attention block (a tensor-parallel
    slot's, KB (a) 6's): g heads of head dim hd in a model of width D (its
    LayerNorm, K edge and out-projection N); g hd need not be D."""
    if g < 1 or d < 1 or hd < 1:
        raise ValueError(f"a head group needs g >= 1 heads of hd >= 1 in D >= 1, got "
                         f"g={g} hd={hd} D={d}")
    hdp = round_up(hd, 64)
    da = g * hdp
    return AttnPlan(d, g, hd, hdp, round_up(d, GEMM_K), da, round_up(3 * da, GEMM_N),
                    round_up(d, GEMM_N))


class MlpPlan(NamedTuple):
    """The MLP block's padded operand layout (``dvl_mlp_block``, K4's
    ``mlp_block_q_impl``): the hidden's F columns in k chunks of ``fb``
    (k = 1 but for K4's F-split), each zero-padded to ``fbp`` = fb rounded
    up to 128 (the GEMMs' N tile and the s8 GEMM's K step; gelu(0) = 0, so
    the padded lanes change no amax and no code), ``fp`` = k fbp in all;
    LayerNorm's output to ``dk``, the down product's N to ``no``."""
    d: int
    f: int
    fb: int
    k: int
    fbp: int
    fp: int
    dk: int
    no: int

    @property
    def identity(self) -> bool:
        return self.fbp == self.fb and self.dk == self.d and self.no == self.d

    def hidden_columns(self) -> torch.Tensor:
        """Where each of the F hidden columns lands in the padded row."""
        j = torch.arange(self.f)
        return (j // self.fb) * self.fbp + j % self.fb

    def crop_hidden(self, t: torch.Tensor) -> torch.Tensor:
        """[..., fp] padded hidden rows -> [..., F]."""
        return t[..., self.hidden_columns().to(t.device)]


def mlp_plan(d: int, f: int, fb: Optional[int] = None) -> MlpPlan:
    fb = f if fb is None else fb
    if d < 1 or fb < 1 or f % fb:
        raise ValueError(f"mlp dim {f} not divisible by fb={fb}")
    fbp = round_up(fb, GEMM_N)
    return MlpPlan(d, f, fb, f // fb, fbp, (f // fb) * fbp, round_up(d, GEMM_K),
                   round_up(d, GEMM_N))


def place(t: torch.Tensor, shape, rows=None, cols=None) -> torch.Tensor:
    """``t`` scattered into zeros of ``shape``: its row i at ``rows[i]`` (at
    i when None), its column j at ``cols[j]`` (at j when None)."""
    out = t.new_zeros(shape)
    if t.dim() == 1:
        out[slice(0, t.shape[0]) if rows is None else rows.to(t.device)] = t
        return out
    if cols is not None:
        wide = t.new_zeros(t.shape[0], shape[1])
        wide[:, cols.to(t.device)] = t
        t = wide
    elif t.shape[1] != shape[1]:
        t = torch.cat([t, t.new_zeros(t.shape[0], shape[1] - t.shape[1])], dim=1)
    out[slice(0, t.shape[0]) if rows is None else rows.to(t.device)] = t
    return out


# ---------------------------------------------------------------------------
# Plain twins (the specification)
# ---------------------------------------------------------------------------


def erf_gelu(h: torch.Tensor) -> torch.Tensor:
    """Exact gelu through the Abramowitz & Stegun 7.1.26 polynomial, the
    same formula the TPU kernel and the CUDA kernel evaluate (|erf err| <=
    1.5e-7).  ``h`` is f32."""
    x = h * 0.7071067811865476
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf = torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))
    return h * 0.5 * (1.0 + erf)


def _act(h: torch.Tensor, act_kind: str) -> torch.Tensor:
    if act_kind == "quick_gelu":
        return quick_gelu(h)
    if act_kind == "gelu":
        return erf_gelu(h)
    raise ValueError(f"act_kind must be one of {ACT_KINDS}, got {act_kind!r}")


def _dot_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with the weight rounded to a's dtype and f32 accumulation."""
    return torch.matmul(a.float(), w.to(a.dtype).float())


def attention_core(qkv: torch.Tensor, heads: int, causal: bool,
                   scale: Optional[float] = None) -> torch.Tensor:
    """The per-head attention of the TPU kernels: qkv [B, S, 3D] (q | k | v)
    -> [B, S, D] in qkv's dtype.  f32 scores and softmax, probabilities
    normalised and rounded before PV, per-head outputs rounded.  ``scale``
    multiplies the scores (1 / sqrt(D / heads) when None; the padded
    layout's core keeps the true head dim's)."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    dt = qkv.dtype
    q, k, v = (t.reshape(b, s, heads, hd).float()
               for t in qkv.split(d, dim=-1))
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        sc = sc + causal_mask(s, qkv.device)
    # the row max is stop-gradiented, as in _kernel_math_resblock: it changes
    # no gradient, and keeps the twin the same function as JAX's
    e = torch.exp(sc - sc.amax(-1, keepdim=True).detach())
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v).to(dt).reshape(b, s, d)


def attention_block_plain(x, ln_s, ln_b, wqkv, bqkv, wo, bo, *, heads: int,
                          causal: bool = False) -> torch.Tensor:
    dt = x.dtype
    xn = ln_f32(x, ln_s, ln_b)
    qkv = (_dot_f32(xn, wqkv) + bqkv.float()).to(dt)
    o = attention_core(qkv, heads, causal)
    proj = _dot_f32(o, wo) + bo.float()
    return (x.float() + proj).to(dt)


def mlp_block_plain(x, ln_s, ln_b, w1, b1, w2, b2, *,
                    act_kind: str = "quick_gelu") -> torch.Tensor:
    xn = ln_f32(x, ln_s, ln_b)
    h = _act(_dot_f32(xn, w1) + b1.float(), act_kind).to(x.dtype)
    return (x.float() + b2.float() + _dot_f32(h, w2)).to(x.dtype)


def pad_cols(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` [..., c] with zero columns appended up to n."""
    return t if t.shape[-1] == n else torch.cat(
        [t, t.new_zeros(*t.shape[:-1], n - t.shape[-1])], dim=-1)


def attention_block_padded(x, ln_s, ln_b, wqkv_p, bqkv_p, wo_p, bo_p, *, plan: AttnPlan,
                           causal: bool = False) -> torch.Tensor:
    """K1's function as its kernel computes it on the padded operand layout
    (``attn_plan``; the operands from ``attn_operands``: K-major wqkv_p
    [nqkv, dk] and wo_p [no, da], bqkv_p [nqkv], bo_p [no]): LayerNorm over
    the true D with zero lanes to dk, the core over hdp lanes a head at the
    true head dim's scale, the out-projection's first D columns.  Equals
    ``attention_block_plain`` on the unpadded operands (the padded lanes
    are zeros throughout) but for the order of f32 sums."""
    dt = x.dtype
    xn = pad_cols(ln_f32(x, ln_s, ln_b), plan.dk)
    qkv = (_dot_f32(xn, wqkv_p.t()) + bqkv_p.float()).to(dt)[..., :3 * plan.da]
    o = attention_core(qkv, plan.heads, causal, scale=plan.scale)
    proj = (_dot_f32(o, wo_p.t()) + bo_p.float())[..., :plan.d]
    return (x.float() + proj).to(dt)


def mlp_block_padded(x, ln_s, ln_b, w1_p, b1_p, w2_p, b2_p, *, plan: MlpPlan,
                     act_kind: str = "quick_gelu") -> torch.Tensor:
    """K2's function on the padded operand layout (``mlp_plan``; the
    operands from ``mlp_operands``: K-major w1_p [fp, dk] and w2_p [no, fp],
    b1_p [fp], b2_p [no])."""
    d = plan.d
    xn = pad_cols(ln_f32(x, ln_s, ln_b), plan.dk)
    h = _act(_dot_f32(xn, w1_p.t()) + b1_p.float(), act_kind).to(x.dtype)
    return (x.float() + b2_p[:d].float() + _dot_f32(h, w2_p.t())[..., :d]).to(x.dtype)


def attn_operands(wqkv, bqkv, wo, bo, plan: AttnPlan):
    """K1's kernel operands on ``plan``'s layout: wqkv [D, 3 heads hd] and
    wo [heads hd, D] K-major in bf16 with each head's q, k, v columns and wo
    rows at hdp lanes, zeros elsewhere; the biases f32 alike (a head group's
    partial has no ``bo``: None leaves it out)."""
    bf = torch.bfloat16
    cols = plan.qkv_columns()
    ops = (place(wqkv.detach().to(bf).t(), (plan.nqkv, plan.dk), rows=cols),
           place(bqkv.detach().float(), (plan.nqkv,), rows=cols),
           place(wo.detach().to(bf).t(), (plan.no, plan.da), cols=plan.head_lanes()))
    return ops if bo is None else (*ops, place(bo.detach().float(), (plan.no,)))


def mlp_operands(w1, b1, w2, b2, plan: MlpPlan):
    """K2's kernel operands on ``plan``'s layout: w1 [D, F] and w2 [F, D]
    K-major in bf16 with the hidden's columns at their padded lanes (a
    slot's partial has no ``b2``: None leaves it out)."""
    bf = torch.bfloat16
    cols = plan.hidden_columns()
    ops = (place(w1.detach().to(bf).t(), (plan.fp, plan.dk), rows=cols),
           place(b1.detach().float(), (plan.fp,), rows=cols),
           place(w2.detach().to(bf).t(), (plan.no, plan.fp), cols=cols))
    return ops if b2 is None else (*ops, place(b2.detach().float(), (plan.no,)))


def _head_qkv(qkv: torch.Tensor, heads: int, h: int):
    """Head h's q, k, v ([B, S, hd] each) of a packed q | k | v row set."""
    d = qkv.shape[-1] // 3
    hd = d // heads
    return (qkv[..., i * d + h * hd: i * d + (h + 1) * hd] for i in range(3))


def attention_block_heads_plain(x, ln_s, ln_b, wqkv, bqkv, wo, *, heads: int,
                                causal: bool = False, prescaled: bool = False,
                                bo=None) -> torch.Tensor:
    """A head group's share of the attention block: ``wqkv`` [D, 3 g hd] is
    the group's q | k | v columns, ``bqkv`` [3 g hd], ``wo`` [g hd, D] its
    rows of the out-projection, ``heads`` = g.  Returns the f32 partial
    attn_g @ wo, or, given ``bo``, (x + bo) + that partial in x's dtype.

    ``prescaled=False`` is K1's function on the group (``attention_core``:
    scale 1/sqrt(hd), exp, normalised before P @ V, one product over the
    group's heads).  ``prescaled=True`` is KB (a) 6's
    (``_attn_hgrid_kernel``): q already scaled by hd^-0.5 log2 e, exp2,
    the unnormalised exponentials rounded for P @ V and the f32 output
    scaled by 1 / row sum, each head's output rounded before its partial
    projection, the partials accumulated in f32 head by head."""
    dt = x.dtype
    xn = ln_f32(x, ln_s, ln_b)
    qkv = (_dot_f32(xn, wqkv) + bqkv.float()).to(dt)
    acc = None if bo is None else x.float() + bo.float()
    if not prescaled:
        part = _dot_f32(attention_core(qkv, heads, causal), wo)
        return part if acc is None else (acc + part).to(dt)
    hd = wo.shape[0] // heads
    for h, o in enumerate(prescaled_core(qkv, heads, causal)):
        part = _dot_f32(o, wo[h * hd:(h + 1) * hd])
        acc = part if acc is None else acc + part
    return acc if bo is None else acc.to(dt)


def prescaled_core(qkv: torch.Tensor, heads: int, causal: bool = False):
    """KB (a) 5 / 6's attention on q pre-scaled by hd^-0.5 log2 e: per
    head, exp2 of the f32 scores less their row max, the unnormalised
    exponentials rounded to qkv's dtype for P @ V, the f32 output scaled by
    1 / row sum and rounded.  Yields each head's [B, S, hd] output."""
    dt = qkv.dtype
    for h in range(heads):
        q, k, v = (t.float() for t in _head_qkv(qkv, heads, h))
        sc = torch.einsum("bqd,bkd->bqk", q, k)
        if causal:
            sc = sc + causal_mask(sc.shape[-1], sc.device)
        e = torch.exp2(sc - sc.amax(-1, keepdim=True).detach())
        o = torch.einsum("bqk,bkd->bqd", e.to(dt).float(), v)
        yield (o * (1.0 / e.sum(-1, keepdim=True))).to(dt)


def prescale_qkv(wqkv: torch.Tensor, bqkv: torch.Tensor, d: int, heads: int):
    """``prescale_qkv`` of benchmarks/attn_variants.py: wqkv [D, 3D] and
    bqkv [3D] with the q columns times hd^-0.5 log2 e (the host-side weight
    transform of KB (a) 5 and 6)."""
    scale = (d // heads) ** -0.5 * LOG2E
    return (torch.cat([wqkv[:, :d] * scale, wqkv[:, d:]], dim=1),
            torch.cat([bqkv[:d] * scale, bqkv[d:]]))


def attention_block_opt_plain(x, ln_s, ln_b, wqkv_s, bqkv_s, wo, bo, *,
                              heads: int) -> torch.Tensor:
    """KB (a) 5's function (``_attn_opt_kernel``): K1 on the pre-scaled
    ``wqkv_s`` / ``bqkv_s`` with ``prescaled_core``'s attention, then one
    out-projection over the concatenated heads, x + (attn @ wo + bo)."""
    dt = x.dtype
    xn = ln_f32(x, ln_s, ln_b)
    qkv = (_dot_f32(xn, wqkv_s) + bqkv_s.float()).to(dt)
    attn = torch.cat(list(prescaled_core(qkv, heads)), dim=-1)
    proj = _dot_f32(attn, wo) + bo.float()
    return (x.float() + proj).to(dt)


def hgrid_qkv(wqkv_h, bqkv_h, h0: int, g: int):
    """KB (a) 6's per-head QKV blocks of heads [h0, h0 + g) -- ``wqkv_h``
    [H, D, 3 hd] (q | k | v of one head each), ``bqkv_h`` [H, 3 hd] -- as
    one head group's packed [D, 3 g hd]: the group's q columns, then its k,
    then its v (a permutation of columns), and the bias alike."""
    hd = wqkv_h.shape[-1] // 3
    blk, bias = wqkv_h[h0:h0 + g], bqkv_h[h0:h0 + g]
    w = torch.cat([blk[..., i * hd:(i + 1) * hd].permute(1, 0, 2).reshape(blk.shape[1], g * hd)
                   for i in range(3)], dim=1)
    b = torch.cat([bias[:, i * hd:(i + 1) * hd].reshape(g * hd) for i in range(3)])
    return w, b


def hgrid_group(wqkv_h, bqkv_h, wo_h, h0: int, g: int):
    """``hgrid_qkv`` and wo_h's [H hd, D] rows of the group."""
    hd = wqkv_h.shape[-1] // 3
    return (*hgrid_qkv(wqkv_h, bqkv_h, h0, g), wo_h[h0 * hd:(h0 + g) * hd])


def attention_block_hgrid_plain(x, ln_s, ln_b, wqkv_h, bqkv_h, wo_h, bo, *,
                                heads: int, h0: int = 0, g=None) -> torch.Tensor:
    """KB (a) 6's function (``attention_block_hgrid`` of
    benchmarks/attn_variants.py) with its arguments; on a head group
    [h0, h0 + g) with g < heads, the group's f32 partial."""
    g = heads if g is None else g
    return attention_block_heads_plain(
        x, ln_s, ln_b, *hgrid_group(wqkv_h, bqkv_h, wo_h, h0, g), heads=g,
        prescaled=True, bo=bo if g == heads else None)


def mlp_block_cols_plain(x, ln_s, ln_b, w1, b1, w2, *,
                         act_kind: str = "quick_gelu") -> torch.Tensor:
    """The f32 partial of the MLP over hidden columns: ``w1`` [D, Fj],
    ``b1`` [Fj], ``w2`` [Fj, D] (K2's rounding points, no b2 or residual)."""
    xn = ln_f32(x, ln_s, ln_b)
    h = _act(_dot_f32(xn, w1) + b1.float(), act_kind).to(x.dtype)
    return _dot_f32(h, w2)


def tp_reduce_plain(parts, bias, resid, *, bias_first: bool) -> torch.Tensor:
    """resid + (sum(parts) + bias) (the attention half: K1's order), or
    (resid + bias) + sum(parts) (``bias_first``, the MLP half: K2's), the
    f32 partials summed in slot order, in resid's dtype."""
    s = parts[0]
    for part in parts[1:]:
        s = s + part
    r, b = resid.float(), bias.float()
    return (((r + b) + s) if bias_first else (r + (s + b))).to(resid.dtype)


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load

        lib = load("fused_block")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dvl_attention_block.argtypes = [p] * 11 + [i] * 6 + [ctypes.c_float, p]
        lib.dvl_attention_block.restype = i
        lib.dvl_attention_block_opt.argtypes = [p] * 11 + [i] * 5 + [p]
        lib.dvl_attention_block_opt.restype = i
        lib.dvl_mlp_block.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.dvl_mlp_block.restype = i
        lib.dvl_attention_block_heads.argtypes = ([p] * 12 + [i] * 6
                                                  + [ctypes.c_float, i, p])
        lib.dvl_attention_block_heads.restype = i
        lib.dvl_mlp_block_cols.argtypes = [p] * 9 + [i] * 4 + [p]
        lib.dvl_mlp_block_cols.restype = i
        lib.dvl_tp_reduce.argtypes = [p, i, p, p, p, i, i, i, p]
        lib.dvl_tp_reduce.restype = i
        _LIB = lib
    return _LIB


def build() -> None:
    """Compile (if needed) and load the kernels now rather than at first use."""
    _lib()


def _check_operand(t: torch.Tensor, shape, name: str, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")


def _operand(t: torch.Tensor, dtype, shape, name: str,
             device) -> torch.Tensor:
    """Cast/copy a parameter to the kernel's dtype, contiguous and 16-byte
    aligned; shape and device are checked, never repaired."""
    _check_operand(t, shape, name, device)
    t = t.to(dtype).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


# K-major ([N, K]) bf16 copies of the [K, N] weights, one per parameter,
# rebuilt whenever the parameter's storage or version counter moves, so a
# trained weight never meets a stale copy.
_KMAJOR = WeakIdKeyDictionary()


def _kmajor(w: torch.Tensor, shape, name: str, device) -> torch.Tensor:
    """The [N, K] bf16 copy of a [K, N] weight."""
    key = (w.data_ptr(), w._version)
    hit = _KMAJOR.get(w)
    if hit is not None and hit[0] == key:
        return hit[1]
    t = _operand(w.detach(), torch.bfloat16, shape, name, device).t().contiguous()
    _KMAJOR[w] = (key, t)
    return t


# The padded operand layouts' copies (``attn_plan`` / ``mlp_plan``), one set
# per block's first parameter and tag (the plan), rebuilt whenever the
# storage or version counter of any of the set's parameters moves.
_PLANNED = WeakIdKeyDictionary()


def planned(ts, tag, build):
    """``build()``'s tensors for the parameters ``ts`` under ``tag``, kept
    per version of every one of them."""
    key = tuple((t.data_ptr(), t._version) for t in ts)
    cache = _PLANNED.get(ts[0])
    if cache is None:
        cache = _PLANNED[ts[0]] = {}
    hit = cache.get(tag)
    if hit is not None and hit[0] == key:
        return hit[1]
    out = tuple(t.contiguous() for t in build())
    cache[tag] = (key, out)
    return out


def _attn_kernel_ops(wqkv, bqkv, wo, bo, plan: AttnPlan, device):
    """K1's weights and biases as the kernel reads them: the plain K-major
    copies where the plan is the identity, else ``attn_operands``'s."""
    d, f32 = plan.d, torch.float32
    if plan.identity:
        return (_kmajor(wqkv, (d, 3 * d), "wqkv", device), _operand(bqkv, f32, (3 * d,), "bqkv", device),
                _kmajor(wo, (d, d), "wo", device), _operand(bo, f32, (d,), "bo", device))
    for t, shape, name in ((wqkv, (d, 3 * d), "wqkv"), (bqkv, (3 * d,), "bqkv"),
                           (wo, (d, d), "wo"), (bo, (d,), "bo")):
        _check_operand(t, shape, name, device)
    return planned((wqkv, bqkv, wo, bo), ("attn", plan),
                   lambda: attn_operands(wqkv, bqkv, wo, bo, plan))


def _mlp_kernel_ops(w1, b1, w2, b2, plan: MlpPlan, device):
    """K2's weights and biases as the kernel reads them (``mlp_operands``
    off the identity)."""
    d, f, f32 = plan.d, plan.f, torch.float32
    if plan.identity:
        return (_kmajor(w1, (d, f), "w1", device), _operand(b1, f32, (f,), "b1", device),
                _kmajor(w2, (f, d), "w2", device), _operand(b2, f32, (d,), "b2", device))
    for t, shape, name in ((w1, (d, f), "w1"), (b1, (f,), "b1"), (w2, (f, d), "w2"),
                           (b2, (d,), "b2")):
        _check_operand(t, shape, name, device)
    return planned((w1, b1, w2, b2), ("mlp", plan),
                   lambda: mlp_operands(w1, b1, w2, b2, plan))


def _padded_bias(b: torch.Tensor, n: int, n_pad: int, name: str, device) -> torch.Tensor:
    t = _operand(b, torch.float32, (n,), name, device)
    return torch.cat([t, t.new_zeros(n_pad - n)]) if n_pad > n else t


def _check_x(x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA fused-block kernels take bfloat16 "
                        f"activations, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, D], got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _attention_block_cuda(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, causal, opt=False):
    """K1's launch on ``attn_plan``'s layout (any D and head dim), or with
    ``opt`` KB (a) 5's (``dvl_attention_block_opt``: the same arguments and
    layout, q pre-scaled, no causal mask)."""
    _check_x(x)
    b, s, d = x.shape
    if s < 1:
        raise ValueError(f"sequence length {s} < 1")
    plan = attn_plan(d, heads)
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    ops = [_operand(ln_s, f32, (d,), "ln_scale", dev),
           _operand(ln_b, f32, (d,), "ln_bias", dev),
           *_attn_kernel_ops(wqkv, bqkv, wo, bo, plan, dev)]
    m = b * s
    out = torch.empty_like(x)
    xn = torch.empty((m, plan.dk), dtype=bf, device=dev)
    qkv = torch.empty((m, plan.nqkv), dtype=bf, device=dev)
    attn = torch.empty((m, plan.da), dtype=bf, device=dev)
    ptrs = (x.data_ptr(), *[t.data_ptr() for t in ops], out.data_ptr(),
            xn.data_ptr(), qkv.data_ptr(), attn.data_ptr())
    if opt:
        err = _lib().dvl_attention_block_opt(*ptrs, b, s, d, heads, plan.hdp, _stream_ptr(dev))
        _raise_on(err, "dvl_attention_block_opt")
        KB_LAUNCHES["attention_block_opt"] += 1
    else:
        err = _lib().dvl_attention_block(*ptrs, b, s, d, heads, plan.hdp, int(causal),
                                         plan.scale, _stream_ptr(dev))
        _raise_on(err, "dvl_attention_block")
        LAUNCHES["attention_block_causal" if causal else "attention_block"] += 1
    CORE_ROUTES[core_route(s, plan.hd)] += 1
    check_nans("dvl_attention_block_opt" if opt else "dvl_attention_block", out)
    return out


def _mlp_block_cuda(x, ln_s, ln_b, w1, b1, w2, b2, act_kind):
    """K2's launch on ``mlp_plan``'s layout (any D and F)."""
    _check_x(x)
    b, s, d = x.shape
    plan = mlp_plan(d, w1.shape[-1])
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    ops = [_operand(ln_s, f32, (d,), "ln_scale", dev),
           _operand(ln_b, f32, (d,), "ln_bias", dev),
           *_mlp_kernel_ops(w1, b1, w2, b2, plan, dev)]
    m = b * s
    out = torch.empty_like(x)
    xn = torch.empty((m, plan.dk), dtype=bf, device=dev)
    hidden = torch.empty((m, plan.fp), dtype=bf, device=dev)
    err = _lib().dvl_mlp_block(
        x.data_ptr(), *[t.data_ptr() for t in ops], out.data_ptr(),
        xn.data_ptr(), hidden.data_ptr(), m, d, plan.fp,
        ACT_KINDS.index(act_kind), _stream_ptr(dev))
    _raise_on(err, "dvl_mlp_block")
    LAUNCHES["mlp_block"] += 1
    check_nans("dvl_mlp_block", out)
    return out


def _group_kernel_ops(wqkv, bqkv, wo, plan: AttnPlan, device):
    """A head group's weights as ``dvl_attention_block_heads`` reads them
    (``wqkv`` [D, 3 g hd], ``bqkv``, ``wo`` [g hd, D]): ``attn_operands`` on
    ``plan`` (``group_plan``; at head dim 64 and D % 128 == 0 the K-major
    copies with zero rows up to the qkv GEMM's N tile), kept per version."""
    d, n = plan.d, 3 * plan.heads * plan.hd
    for t, shape, name in ((wqkv, (d, n), "wqkv"), (bqkv, (n,), "bqkv"), (wo, (n // 3, d), "wo")):
        _check_operand(t, shape, name, device)
    return planned((wqkv, bqkv, wo), ("group", plan),
                   lambda: attn_operands(wqkv, bqkv, wo, None, plan))


def _attention_heads_cuda(x, ln_s, ln_b, ops, bo, plan: AttnPlan, causal, prescaled, counter):
    """``dvl_attention_block_heads`` on a head group's kernel operands
    (``_group_kernel_ops`` on ``plan``); the f32 partial, or with ``bo`` the
    bf16 block output."""
    _check_x(x)
    b, s, d = x.shape
    if s < 1:
        raise ValueError(f"sequence length {s} < 1")
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    ops = [_operand(ln_s, f32, (d,), "ln_scale", dev),
           _operand(ln_b, f32, (d,), "ln_bias", dev), *ops]
    m = b * s
    out = torch.empty_like(x) if bo is not None else None
    part = None if bo is not None else torch.empty((b, s, d), dtype=f32, device=dev)
    xn = torch.empty((m, plan.dk), dtype=bf, device=dev)
    qkv = torch.empty((m, plan.nqkv), dtype=bf, device=dev)
    attn = torch.empty((m, plan.da), dtype=bf, device=dev)
    err = _lib().dvl_attention_block_heads(
        x.data_ptr(), *[t.data_ptr() for t in ops],
        _padded_bias(bo, d, plan.no, "bo", dev).data_ptr() if bo is not None else None,
        out.data_ptr() if out is not None else None,
        part.data_ptr() if part is not None else None,
        xn.data_ptr(), qkv.data_ptr(), attn.data_ptr(), b, s, d, plan.heads, plan.hdp,
        int(causal), math.log(2.0) if prescaled else plan.scale, int(prescaled),
        _stream_ptr(dev))
    _raise_on(err, "dvl_attention_block_heads")
    TP_LAUNCHES[counter] += 1
    CORE_ROUTES[core_route(s, plan.hd)] += 1
    check_nans("dvl_attention_block_heads", part if out is None else out)
    return part if out is None else out


# KB (a) 6's head groups in the kernel's layout, one entry per (h0, g) of a
# wqkv_h parameter, rebuilt when it, its bias or wo_h moves (a permutation
# of columns onto the group's padded layout: bit-preserving)
_HGRID = WeakIdKeyDictionary()


def _hgrid_kernel_ops(wqkv_h, bqkv_h, wo_h, h0, g, plan: AttnPlan, device):
    key = (wqkv_h.data_ptr(), wqkv_h._version, bqkv_h.data_ptr(), bqkv_h._version,
           wo_h.data_ptr(), wo_h._version)
    cache = _HGRID.get(wqkv_h)
    if cache is None or cache[0] != key:
        cache = (key, {})
        _HGRID[wqkv_h] = cache
    if (h0, g) not in cache[1]:
        w, b, wo = (t.to(device) for t in hgrid_group(wqkv_h.detach(), bqkv_h.detach(),
                                                      wo_h.detach(), h0, g))
        ops = attn_operands(w, b, wo, None, plan)
        cache[1][(h0, g)] = tuple(t.contiguous() for t in ops)
    return cache[1][(h0, g)]


def _mlp_cols_cuda(x, ln_s, ln_b, w1, b1, w2, act_kind):
    """``dvl_mlp_block_cols`` on ``mlp_plan``'s layout of the slot's hidden
    columns (any D and Fj; the plain K-major copies where the plan is the
    identity)."""
    _check_x(x)
    b, s, d = x.shape
    fj = w1.shape[-1]
    plan = mlp_plan(d, fj)
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    if plan.identity:
        wops = (_kmajor(w1, (d, fj), "w1", dev), _operand(b1, f32, (fj,), "b1", dev),
                _kmajor(w2, (fj, d), "w2", dev))
    else:
        for t, shape, name in ((w1, (d, fj), "w1"), (b1, (fj,), "b1"), (w2, (fj, d), "w2")):
            _check_operand(t, shape, name, dev)
        wops = planned((w1, b1, w2), ("cols", plan), lambda: mlp_operands(w1, b1, w2, None, plan))
    ops = [_operand(ln_s, f32, (d,), "ln_scale", dev),
           _operand(ln_b, f32, (d,), "ln_bias", dev), *wops]
    m = b * s
    part = torch.empty((b, s, d), dtype=f32, device=dev)
    xn = torch.empty((m, plan.dk), dtype=bf, device=dev)
    hidden = torch.empty((m, plan.fp), dtype=bf, device=dev)
    err = _lib().dvl_mlp_block_cols(
        x.data_ptr(), *[t.data_ptr() for t in ops], part.data_ptr(), xn.data_ptr(),
        hidden.data_ptr(), m, d, plan.fp, ACT_KINDS.index(act_kind), _stream_ptr(dev))
    _raise_on(err, "dvl_mlp_block_cols")
    TP_LAUNCHES["mlp_block_cols"] += 1
    check_nans("dvl_mlp_block_cols", part)
    return part


def check_parts(n: int, what: str) -> None:
    """One launch sums 1 to ``TP_PARTS`` slots' partials."""
    if not 1 <= n <= TP_PARTS:
        raise ValueError(f"{what} takes 1 to {TP_PARTS} slots' partials, got {n}")


def _tp_reduce_cuda(parts, bias, resid, bias_first):
    _check_x(resid)
    dev = resid.device
    n = resid.shape[-1]
    check_parts(len(parts), "tp_reduce")
    for t in parts:
        if t.dtype != torch.float32 or t.shape != resid.shape or t.device != dev:
            raise ValueError(f"tp_reduce: each partial must be f32 {tuple(resid.shape)} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    parts = [t.contiguous() for t in parts]
    out = torch.empty_like(resid)
    ptrs = (ctypes.c_void_p * len(parts))(*[t.data_ptr() for t in parts])
    err = _lib().dvl_tp_reduce(ptrs, len(parts),
                               _operand(bias, torch.float32, (n,), "bias", dev).data_ptr(),
                               resid.data_ptr(), out.data_ptr(), resid.numel() // n, n,
                               int(bias_first), _stream_ptr(dev))
    _raise_on(err, "dvl_tp_reduce")
    TP_LAUNCHES["tp_reduce"] += 1
    check_nans("dvl_tp_reduce", out)
    return out


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _route(x: torch.Tensor) -> str:
    if x.device.type in ("cpu", "cuda"):
        return x.device.type
    raise ValueError(f"fused blocks run on cpu (plain twin) or cuda "
                     f"(kernel), got {x.device}")


def attention_block(x, ln_s, ln_b, wqkv, bqkv, wo, bo, *, heads: int,
                    causal: bool = False) -> torch.Tensor:
    """x: [B, S, D] -> x + attn(LN(x)); ``causal`` applies CLIP's text mask."""
    if _route(x) == "cpu":
        return attention_block_plain(x, ln_s, ln_b, wqkv, bqkv, wo, bo,
                                     heads=heads, causal=causal)
    return _attention_block_cuda(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads,
                                 causal)


def mlp_block(x, ln_s, ln_b, w1, b1, w2, b2, *,
              act_kind: str = "quick_gelu") -> torch.Tensor:
    """x: [B, S, D] -> x + mlp(LN(x))."""
    if act_kind not in ACT_KINDS:
        raise ValueError(f"act_kind must be one of {ACT_KINDS}, "
                         f"got {act_kind!r}")
    if _route(x) == "cpu":
        return mlp_block_plain(x, ln_s, ln_b, w1, b1, w2, b2,
                               act_kind=act_kind)
    return _mlp_block_cuda(x, ln_s, ln_b, w1, b1, w2, b2, act_kind)


def attention_block_opt(x, ln_s, ln_b, wqkv_s, bqkv_s, wo, bo, *,
                        heads: int) -> torch.Tensor:
    """KB (a) 5, ``attention_block_opt`` of benchmarks/attn_variants.py,
    with its arguments: ``wqkv_s`` [D, 3D] / ``bqkv_s`` [3D] with the q
    columns pre-scaled by ``prescale_qkv``; x + the block in x's dtype.  On
    a card K1's launches with the core at scale ln 2 (exp2) normalising
    after P @ V (past 320 keys on its long route)."""
    if _route(x) == "cpu":
        return attention_block_opt_plain(x, ln_s, ln_b, wqkv_s, bqkv_s, wo, bo, heads=heads)
    return _attention_block_cuda(x, ln_s, ln_b, wqkv_s, bqkv_s, wo, bo, heads, False, opt=True)


def attention_block_heads(x, ln_s, ln_b, wqkv, bqkv, wo, *, heads: int,
                          causal: bool = False) -> torch.Tensor:
    """A head group's f32 partial of K1 (``attention_block_heads_plain``):
    ``heads`` = the group's g heads, ``wqkv`` [D, 3 g hd] its q | k | v
    columns, ``wo`` [g hd, D] its rows of the out-projection."""
    if _route(x) == "cpu":
        return attention_block_heads_plain(x, ln_s, ln_b, wqkv, bqkv, wo, heads=heads,
                                           causal=causal)
    plan = group_plan(x.shape[-1], wo.shape[0] // heads, heads)
    return _attention_heads_cuda(x, ln_s, ln_b, _group_kernel_ops(wqkv, bqkv, wo, plan, x.device),
                                 None, plan, causal, False,
                                 "attention_block_heads_causal" if causal
                                 else "attention_block_heads")


def attention_block_hgrid(x, ln_s, ln_b, wqkv_h, bqkv_h, wo_h, bo, *, heads: int,
                          h0: int = 0, g=None) -> torch.Tensor:
    """KB (a) 6, ``attention_block_hgrid`` of benchmarks/attn_variants.py,
    with its arguments: ``wqkv_h`` [H, D, 3 hd] per-head blocks with q
    pre-scaled by hd^-0.5 log2 e (its ``prescale_qkv``), ``bqkv_h`` [H, 3
    hd], ``wo_h`` [H hd, D]; x + the block in x's dtype.  With ``g`` < heads,
    the f32 partial of heads [h0, h0 + g) (no bias, no residual).  On a card
    the head group is one launch of ``dvl_attention_block_heads`` at the
    core's scale ln 2 with the normalisation after P @ V."""
    g = heads if g is None else g
    if h0 < 0 or g < 1 or h0 + g > heads:
        raise ValueError(f"head group [{h0}, {h0 + g}) outside {heads} heads")
    if _route(x) == "cpu":
        return attention_block_hgrid_plain(x, ln_s, ln_b, wqkv_h, bqkv_h, wo_h, bo,
                                           heads=heads, h0=h0, g=g)
    plan = group_plan(x.shape[-1], wqkv_h.shape[-1] // 3, g)
    return _attention_heads_cuda(
        x, ln_s, ln_b, _hgrid_kernel_ops(wqkv_h, bqkv_h, wo_h, h0, g, plan, x.device),
        bo if g == heads else None, plan, False, True, "attention_block_hgrid")


def mlp_block_cols(x, ln_s, ln_b, w1, b1, w2, *,
                   act_kind: str = "quick_gelu") -> torch.Tensor:
    """The f32 partial of K2 over a slot's hidden columns (``w1`` [D, Fj],
    ``b1`` [Fj], ``w2`` [Fj, D]): no b2, no residual."""
    if act_kind not in ACT_KINDS:
        raise ValueError(f"act_kind must be one of {ACT_KINDS}, got {act_kind!r}")
    if _route(x) == "cpu":
        return mlp_block_cols_plain(x, ln_s, ln_b, w1, b1, w2, act_kind=act_kind)
    return _mlp_cols_cuda(x, ln_s, ln_b, w1, b1, w2, act_kind)


def tp_reduce(parts, bias, resid, *, bias_first: bool) -> torch.Tensor:
    """The row-parallel sum of the slots' f32 partials (all on resid's
    device) + bias + resid, one rounding (``tp_reduce_plain``)."""
    if _route(resid) == "cpu":
        return tp_reduce_plain(parts, bias, resid, bias_first=bias_first)
    return _tp_reduce_cuda(parts, bias, resid, bias_first)


def _block_args(block):
    a, m = block.attn, block.mlp
    return ((block.ln_1.scale, block.ln_1.bias, a.wqkv, a.bqkv, a.wo, a.bo),
            (block.ln_2.scale, block.ln_2.bias, m.w1, m.b1, m.w2, m.b2))


def fused_resblock(block, x: torch.Tensor, heads: int, *,
                   act_kind: str = "quick_gelu",
                   causal: bool = False) -> torch.Tensor:
    """One pre-LN residual block (a ``models.layers.ResidualBlock``) through
    the two fused entry points."""
    attn_args, mlp_args = _block_args(block)
    x = attention_block(x, *attn_args, heads=heads, causal=causal)
    return mlp_block(x, *mlp_args, act_kind=act_kind)


def fused_transformer(blocks, x: torch.Tensor, heads: int, *,
                      act_kind: str = "quick_gelu",
                      causal: bool = False) -> torch.Tensor:
    for block in blocks:
        x = fused_resblock(block, x, heads, act_kind=act_kind, causal=causal)
    return x


# ---------------------------------------------------------------------------
# Differentiable blocks: kernel forward, twin-recompute backward
# ---------------------------------------------------------------------------


def resblock_plain(x, params, heads: int, act_kind: str = "quick_gelu",
                   causal: bool = False) -> torch.Tensor:
    """The two twins in a row (the port of ``_kernel_math_resblock``);
    ``params`` are the 12 block tensors in ``_block_args`` order."""
    y = attention_block_plain(x, *params[:6], heads=heads, causal=causal)
    return mlp_block_plain(y, *params[6:], act_kind=act_kind)


class _FusedResblockFn(torch.autograd.Function):
    """Forward through ``attention_block`` + ``mlp_block`` (the kernels on a
    CUDA tensor), backward by autograd through ``resblock_plain``
    recomputed from the saved inputs: the gradients of the function the
    forward evaluated, for ``x`` and each of the 12 block tensors."""

    @staticmethod
    def forward(ctx, heads, act_kind, causal, x, *params):
        ctx.cfg = (heads, act_kind, causal)
        ctx.save_for_backward(x, *params)
        y = attention_block(x, *params[:6], heads=heads, causal=causal)
        return mlp_block(y, *params[6:], act_kind=act_kind)

    @staticmethod
    def backward(ctx, g):
        heads, act_kind, causal = ctx.cfg
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = resblock_plain(inputs[0], inputs[1:], heads, act_kind, causal)
            wanted = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        return (None, None, None) + tuple(next(grads) if n else None for n in need)


def fused_resblock_diff(block, x: torch.Tensor, heads: int, *,
                        act_kind: str = "quick_gelu",
                        causal: bool = False) -> torch.Tensor:
    """``fused_resblock`` with a backward (``_FusedResblockFn``)."""
    if act_kind not in ACT_KINDS:
        raise ValueError(f"act_kind must be one of {ACT_KINDS}, "
                         f"got {act_kind!r}")
    attn_args, mlp_args = _block_args(block)
    return _FusedResblockFn.apply(heads, act_kind, causal, x, *attn_args,
                                  *mlp_args)


def fused_transformer_diff(blocks, x: torch.Tensor, heads: int, *,
                           act_kind: str = "quick_gelu",
                           causal: bool = False) -> torch.Tensor:
    """Differentiable fused tower: one ``fused_resblock_diff`` per block."""
    for block in blocks:
        x = fused_resblock_diff(block, x, heads, act_kind=act_kind,
                                causal=causal)
    return x
