"""Attention ops on [B, H, S, hd] (heads-first) inputs: the hand-written CUDA
kernel ``attention_pallas`` with its plain twin, and the plain reference.

Counterpart of ``debias_vision_lang_tpu/ops/attention.py``:

  attention_reference     plain attention; at bfloat16 the bf16-softmax
                          branch of the JAX function (bf16 scores, an
                          f32-summed denominator rounded to bf16)
  attention_kernel_math   the kernel's function and its specification
                          (``_attention_kernel_math``): input-dtype products
                          accumulated in f32, ``scores * scale + mask`` and
                          the softmax in f32, probabilities normalised and
                          rounded to v's dtype before PV, output rounded
  attention_pallas        the CUDA kernels (``csrc/attention.cu``) on a CUDA
                          tensor, the twin on a CPU tensor; nothing falls
                          back.  The name is the JAX function's, whose body
                          was the Pallas TPU kernel.  ``_plan`` picks the
                          route from the shape alone: the short routes
                          (S <= 320, head dim 64: bf16 on K1's wgmma core,
                          float32 with both products on the tensor cores as
                          3xTF32, big*big + big*small + small*big of TF32
                          halves, within 2e-5 of the twin), or the long
                          route for every other shape with a head dim up
                          to 192 (two passes over 64-key tiles on TMA-fed
                          wgmma: the row max and a rescaled row sum, then
                          the normalised P V; the head dim zero-padded to
                          64, 128 or 192 with the original head dim's
                          scale, as the JAX function pads to 128 lanes)
  attention               dispatch: ``use_pallas=True`` goes through
                          ``attention_pallas`` with a backward that
                          differentiates the twin (``_attention_pallas_bwd``)

The mask is additive f32 [S, S] (CLIP's causal mask holds -inf above the
diagonal).  ``LAUNCHES`` counts kernel launches per route
(``attention_pallas`` the short routes, ``attention_pallas_long`` the long
one); CPU twins never count.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from ..models.layers import attention_bshd
from ..utils.observability import check_nans

LAUNCHES: Dict[str, int] = {"attention_pallas": 0, "attention_pallas_long": 0}
HEAD_DIM = 64   # the short routes' head dim, and the long route's dim tile
SHORT_MAX_SEQ = 320  # keys per score row the short routes hold in registers
LONG_MAX_HEAD_DIM = 192  # the long route's widest padded head dim


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _zero_mask(q: torch.Tensor) -> torch.Tensor:
    s = q.shape[2]
    return torch.zeros((s, s), dtype=torch.float32, device=q.device)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def attention_reference(q, k, v, mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain attention, q, k, v [B, H, S, hd], additive mask [S, S] or None:
    ``models/layers.py::attention_bshd`` in the heads-first layout."""
    return attention_bshd(*(t.transpose(1, 2) for t in (q, k, v)),
                          mask).transpose(1, 2)


def attention_kernel_math(q, k, v, mask: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function (the JAX ``_attention_kernel_math``), as
    differentiable torch; the row max is stop-gradiented as there.
    ``scale`` defaults to 1/sqrt(head dim); the long route passes the
    original head dim's when the operands are zero-padded."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = s + mask.float()
    e = torch.exp(s - s.amax(-1, keepdim=True).detach())
    p = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load

        lib = load("attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dvl_attention.argtypes = [p] * 5 + [i] * 5 + [ctypes.c_float, p]
        lib.dvl_attention.restype = i
        _LIB = lib
    return _LIB


def build() -> None:
    """Compile (if needed) and load the kernel now rather than at first use."""
    _lib()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t.clone() if t.data_ptr() % 16 else t


def _plan(s: int, hd: int) -> str:
    """The CUDA route for a shape, from the shape alone: ``"short"`` (whole
    score rows in registers) for S <= 320 and head dim 64, ``"long"`` for
    every other shape."""
    return "short" if s <= SHORT_MAX_SEQ and hd == HEAD_DIM else "long"


def _padded_head_dim(hd: int) -> int:
    return HEAD_DIM * -(-hd // HEAD_DIM)


def _pad_head_dim(t: torch.Tensor, hdp: int) -> torch.Tensor:
    """Zero columns up to head dim ``hdp``: they change no score and add
    only zero output columns."""
    hd = t.shape[-1]
    return t if hd == hdp else torch.nn.functional.pad(t, (0, hdp - hd))


def _long_route_mask(mask: torch.Tensor) -> torch.Tensor:
    """The long route's mask: [S, S] f32 -> [S, S rounded up to 64], the
    columns past S at -inf.  The kernel reads it in 64-key tiles through a
    TMA map (rows 16 bytes apart), and the -inf columns mask the keys past
    S, so it tests no key index."""
    s = mask.shape[-1]
    if s % HEAD_DIM == 0:
        return mask
    return torch.nn.functional.pad(mask, (0, -s % HEAD_DIM), value=-math.inf)


def _attention_cuda(q, k, v, mask: torch.Tensor) -> torch.Tensor:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, H, S, hd] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must have one dtype")
    b, h, s, hd = q.shape
    if tuple(mask.shape) != (s, s):
        raise ValueError(f"mask must be [S, S] = [{s}, {s}], got "
                         f"{tuple(mask.shape)}")
    dev = q.device
    if k.device != dev or v.device != dev or mask.device != dev:
        raise ValueError("q, k, v and mask must be on one device")
    route = _plan(s, hd)
    hdp = _padded_head_dim(hd)
    if hdp > LONG_MAX_HEAD_DIM:
        raise ValueError(f"the CUDA attention kernel takes head dims up to "
                         f"{LONG_MAX_HEAD_DIM}, got {hd}")
    # the heads-first layout comes from a transpose: copy views to rows; the
    # kernels take 16-byte aligned bases
    q, k, v = (_aligned(_pad_head_dim(t, hdp).contiguous()) for t in (q, k, v))
    mask = mask.to(torch.float32).contiguous()
    mask = _aligned(_long_route_mask(mask) if route == "long" else mask)
    out = torch.empty_like(q)
    err = _lib().dvl_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), b * h, s, hdp, int(q.dtype == torch.bfloat16),
        int(route == "long"), ctypes.c_float(1.0 / math.sqrt(hd)),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"dvl_attention ({route} route): CUDA error {err} "
                           f"({torch.cuda.get_device_name(dev)})")
    LAUNCHES["attention_pallas_long" if route == "long" else "attention_pallas"] += 1
    check_nans("dvl_attention", out)
    return out if hdp == hd else out[..., :hd].contiguous()


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def attention_pallas(q, k, v, mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + mask) v over [B, H, S, hd], any S: the
    CUDA kernels (``csrc/attention.cu``, the route from ``_plan``; head dims
    up to 192) on a CUDA tensor, ``attention_kernel_math`` on a CPU tensor
    (any head dim)."""
    if mask is None:
        mask = _zero_mask(q)
    if q.device.type == "cpu":
        return attention_kernel_math(q, k, v, mask)
    if q.device.type == "cuda":
        return _attention_cuda(q, k, v, mask)
    raise ValueError(f"attention_pallas runs on cpu (plain twin) or cuda "
                     f"(kernel), got {q.device}")


class _AttentionPallasFn(torch.autograd.Function):
    """``_attention_pallas_diff``: forward ``attention_pallas``, backward by
    autograd through ``attention_kernel_math`` recomputed from q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return attention_pallas(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_kernel_math(*qkv, mask)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None


def attention(q, k, v, mask: Optional[torch.Tensor] = None, *,
              use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Dispatch on [B, H, S, hd]: ``attention_reference`` by default, the
    differentiable ``attention_pallas`` when ``use_pallas``."""
    if use_pallas:
        if mask is None:
            mask = _zero_mask(q)
        return _AttentionPallasFn.apply(q, k, v, mask)
    return attention_reference(q, k, v, mask)
