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
show that its main path went through the kernels.

``fused_resblock_diff`` / ``fused_transformer_diff`` make the blocks
differentiable (as ``_fused_resblock_diff``, a custom VJP in the JAX
package): the forward is the two entry points above -- the kernels on a
CUDA tensor -- and the backward recomputes the block through the plain
twins, the kernels' own math, and differentiates that.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..models.layers import causal_mask, ln_f32, quick_gelu

LAUNCHES: Dict[str, int] = {"attention_block": 0,
                            "attention_block_causal": 0,
                            "mlp_block": 0}
ACT_KINDS = ("quick_gelu", "gelu")
MAX_SEQ = 320  # keys per score row the CUDA attention core holds in registers
GEMM_N, GEMM_K = 128, 64  # the CUDA GEMM's block width and K step: N, K multiples


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def attention_core(qkv: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
    """The per-head attention of the TPU kernels: qkv [B, S, 3D] (q | k | v)
    -> [B, S, D] in qkv's dtype.  f32 scores and softmax, probabilities
    normalised and rounded before PV, per-head outputs rounded."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    dt = qkv.dtype
    q, k, v = (t.reshape(b, s, heads, hd).float()
               for t in qkv.split(d, dim=-1))
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(hd))
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
        lib.dvl_attention_block.argtypes = [p] * 11 + [i] * 5 + [p]
        lib.dvl_attention_block.restype = i
        lib.dvl_mlp_block.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.dvl_mlp_block.restype = i
        _LIB = lib
    return _LIB


def build() -> None:
    """Compile (if needed) and load the kernels now rather than at first use."""
    _lib()


def _operand(t: torch.Tensor, dtype, shape, name: str,
             device) -> torch.Tensor:
    """Cast/copy a parameter to the kernel's dtype, contiguous and 16-byte
    aligned; shape and device are checked, never repaired."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    t = t.to(dtype).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


# K-major ([N, K]) bf16 copies of the [K, N] weights, one per parameter,
# rebuilt whenever the parameter's storage or version counter moves, so a
# trained weight never meets a stale copy.
_KMAJOR = WeakIdKeyDictionary()


def _kmajor(w: torch.Tensor, shape, name: str, device) -> torch.Tensor:
    key = (w.data_ptr(), w._version)
    hit = _KMAJOR.get(w)
    if hit is not None and hit[0] == key:
        return hit[1]
    t = _operand(w.detach(), torch.bfloat16, shape, name, device).t().contiguous()
    _KMAJOR[w] = (key, t)
    return t


def _check_gemm(n: int, k: int, what: str) -> None:
    if n % GEMM_N or k % GEMM_K:
        raise ValueError(f"the CUDA GEMM takes N % {GEMM_N} == 0 and K % {GEMM_K} "
                         f"== 0, got N={n} K={k} ({what})")


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


def _attention_block_cuda(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, causal):
    _check_x(x)
    b, s, d = x.shape
    if d % heads or d // heads != 64:
        raise ValueError(f"the CUDA attention core takes head dim 64, got "
                         f"D={d} heads={heads}")
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"sequence length {s} outside 1..{MAX_SEQ}")
    _check_gemm(3 * d, d, "qkv projection")
    _check_gemm(d, d, "out projection")
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    ops = [_operand(ln_s, f32, (d,), "ln_scale", dev),
           _operand(ln_b, f32, (d,), "ln_bias", dev),
           _kmajor(wqkv, (d, 3 * d), "wqkv", dev),
           _operand(bqkv, f32, (3 * d,), "bqkv", dev),
           _kmajor(wo, (d, d), "wo", dev),
           _operand(bo, f32, (d,), "bo", dev)]
    out = torch.empty_like(x)
    xn = torch.empty((b * s, d), dtype=bf, device=dev)
    qkv = torch.empty((b * s, 3 * d), dtype=bf, device=dev)
    attn = torch.empty((b * s, d), dtype=bf, device=dev)
    err = _lib().dvl_attention_block(
        x.data_ptr(), *[t.data_ptr() for t in ops], out.data_ptr(),
        xn.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
        b, s, d, heads, int(causal), _stream_ptr(dev))
    _raise_on(err, "dvl_attention_block")
    LAUNCHES["attention_block_causal" if causal else "attention_block"] += 1
    return out


def _mlp_block_cuda(x, ln_s, ln_b, w1, b1, w2, b2, act_kind):
    _check_x(x)
    b, s, d = x.shape
    f = w1.shape[-1]
    _check_gemm(f, d, "mlp up projection")
    _check_gemm(d, f, "mlp down projection")
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    ops = [_operand(ln_s, f32, (d,), "ln_scale", dev),
           _operand(ln_b, f32, (d,), "ln_bias", dev),
           _kmajor(w1, (d, f), "w1", dev),
           _operand(b1, f32, (f,), "b1", dev),
           _kmajor(w2, (f, d), "w2", dev),
           _operand(b2, f32, (d,), "b2", dev)]
    out = torch.empty_like(x)
    xn = torch.empty((b * s, d), dtype=bf, device=dev)
    hidden = torch.empty((b * s, f), dtype=bf, device=dev)
    err = _lib().dvl_mlp_block(
        x.data_ptr(), *[t.data_ptr() for t in ops], out.data_ptr(),
        xn.data_ptr(), hidden.data_ptr(), b * s, d, f,
        ACT_KINDS.index(act_kind), _stream_ptr(dev))
    _raise_on(err, "dvl_mlp_block")
    LAUNCHES["mlp_block"] += 1
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
