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
  attention_pallas        the CUDA kernel (``csrc/attention.cu``) on a CUDA
                          tensor, the twin on a CPU tensor; nothing falls
                          back.  The name is the JAX function's, whose body
                          was the Pallas TPU kernel
  attention               dispatch: ``use_pallas=True`` goes through
                          ``attention_pallas`` with a backward that
                          differentiates the twin (``_attention_pallas_bwd``)

The mask is additive f32 [S, S] (CLIP's causal mask holds -inf above the
diagonal).  ``LAUNCHES`` counts kernel launches; CPU twins never count.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from ..models.layers import attention_bshd

LAUNCHES: Dict[str, int] = {"attention_pallas": 0}
HEAD_DIM = 64   # the only head dim the CUDA kernel is built for
MAX_SEQ = 320   # keys per score row the CUDA kernel holds in registers


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


def attention_kernel_math(q, k, v, mask: torch.Tensor) -> torch.Tensor:
    """The kernel's function (the JAX ``_attention_kernel_math``), as
    differentiable torch; the row max is stop-gradiented as there."""
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
        lib.dvl_attention.argtypes = [p] * 5 + [i] * 3 + [p]
        lib.dvl_attention.restype = i
        _LIB = lib
    return _LIB


def build() -> None:
    """Compile (if needed) and load the kernel now rather than at first use."""
    _lib()


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
    if hd != HEAD_DIM:
        raise ValueError(f"the CUDA attention kernel takes head dim {HEAD_DIM}, "
                         f"got {hd}")
    if s > MAX_SEQ:
        raise ValueError(f"sequence length {s} > {MAX_SEQ}, the most keys the "
                         f"CUDA attention kernel holds per score row")
    if tuple(mask.shape) != (s, s):
        raise ValueError(f"mask must be [S, S] = [{s}, {s}], got "
                         f"{tuple(mask.shape)}")
    dev = q.device
    if k.device != dev or v.device != dev or mask.device != dev:
        raise ValueError("q, k, v and mask must be on one device")
    # the heads-first layout comes from a transpose: copy views to rows
    q, k, v = (t.contiguous() for t in (q, k, v))
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    err = _lib().dvl_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), b * h, s, int(q.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"dvl_attention: CUDA error {err} "
                           f"({torch.cuda.get_device_name(dev)})")
    LAUNCHES["attention_pallas"] += 1
    return out


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def attention_pallas(q, k, v, mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + mask) v over [B, H, S, hd]: the CUDA kernel
    (``csrc/attention.cu``) on a CUDA tensor, ``attention_kernel_math`` on a
    CPU tensor."""
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
