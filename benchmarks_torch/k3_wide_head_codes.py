"""Why K3's attention codes at one head of 800 dims leave the twin's more
often than phase 6's share bar allows: the int8 block's own rounding noise.

K3 (``ops/fused_block_q.py::attention_block_q``) quantizes each attention
row per row (``quant_rows``); the twin computes that row with one f32
product per head (q k^T over 800 dims, then P V), the CUDA core with the
same products summed in another order (Q K^T over thirteen 64-dim chunks in
wgmma's f32 accumulators, exp2 of the scaled difference, P V over 64-key
tiles).  Rows whose values sit near a code boundary flip with any last-bit
change of the scores, so the share of flipped codes is set by how the sums
are ordered, not by the kernel being wrong.

This script measures that share on the twin's own data (phase 27's shape:
D = 800, one head, B = 4, S = 77, x ~ N(0, 1), the smoke's shape_params
weights at seed 800), for orders that any correct kernel could take:

  * ``chunked``: the scores summed over thirteen 64-dim chunks in f32 (the
    long core's order), the rest as the twin;
  * ``float64``: the scores exact (float64) before their f32 rounding;
  * ``exp2``: the twin's scores, exp as exp2 of (s - m) log2 e in f32 (the
    long core's form);
  * ``keys``: P V summed over 64-key tiles in f32 (the long core's order).

Each prints the share of attention codes that differ from the twin's, the
largest code difference, and the same at head dim 64 (D = 768, 12 heads)
for comparison.  It runs on the card (``--device cuda``, the default; it
exits with an error when no card is found), where it also runs K3 itself
(one head of 800 and of 256, 12 of 64) and prints the share of its
attention codes off the twin's on the card and off the twin's on the CPU,
the share of the twin's own codes that differ between the card and the CPU,
and the share of K3's attention values (bf16) that differ from the card
twin's core.  ``--device cpu`` runs only the twin's order study, on the
CPU, and labels its lines so.

  python3 benchmarks_torch/k3_wide_head_codes.py [--device cuda|cpu]
"""

import argparse
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from debias_vision_lang_torch.models.layers import ln_f32  # noqa: E402
from debias_vision_lang_torch.ops import fused_block as fb  # noqa: E402
from debias_vision_lang_torch.ops import fused_block_q as fbq  # noqa: E402
from debias_vision_lang_torch.ops.quant import QWeight  # noqa: E402


def params(d, device, seed):
    """chip_smoke.shape_params' attention tensors at width d, int8."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(device)

    ls, lb = 1 + 0.1 * rn(d), 0.1 * rn(d)
    wqkv, bqkv = rn(d, 3 * d, std=d ** -0.5), 0.1 * rn(3 * d)
    q = QWeight(wqkv)
    return ls, lb, q.q, q.scale, bqkv


def qkv_of(x, ls, lb, wq, ws, bq):
    """K3's qkv as the twin computes it (bf16)."""
    xq, xs = fbq.quant_rows(ln_f32(x, ls, lb).float())
    return (fbq.dot_q(xq, xs, wq, ws) + bq.float()).to(x.dtype)


def core(qkv, heads, order):
    """The twin's attention core (``fused_block.attention_core``) with one
    step in the order named."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    dt = qkv.dtype
    q, k, v = (t.reshape(b, s, heads, hd).float() for t in qkv.split(d, dim=-1))
    if order == "chunked":
        sc = 0
        for c in range(0, hd, 64):
            sc = sc + torch.einsum("bqhd,bkhd->bhqk", q[..., c:c + 64], k[..., c:c + 64])
    elif order == "float64":
        sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()).float()
    else:
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k)
    sc = sc * (1.0 / math.sqrt(hd))
    diff = sc - sc.amax(-1, keepdim=True)
    e = torch.exp2(diff * math.log2(math.e)) if order == "exp2" else torch.exp(diff)
    p = (e / e.sum(-1, keepdim=True)).to(dt).float()
    vh = v.permute(0, 2, 1, 3)  # [b, h, s, hd]
    if order == "keys":
        o = 0
        for k0 in range(0, s, 64):
            o = o + p[..., k0:k0 + 64] @ vh[:, :, k0:k0 + 64]
    else:
        o = p @ vh
    return o.to(dt).permute(0, 2, 1, 3).reshape(b, s, d)


def share(d, heads, device, seed):
    ls, lb, wq, ws, bq = params(d, device, seed)
    x = torch.randn(4, 77, d, generator=torch.Generator().manual_seed(27 + 77)).to(
        device, torch.bfloat16)
    qkv = qkv_of(x, ls, lb, wq, ws, bq)
    ref = fbq.quant_rows(fb.attention_core(qkv, heads, False).float())[0]
    out = {}
    for order in ("chunked", "float64", "exp2", "keys"):
        got = fbq.quant_rows(core(qkv, heads, order).float())[0]
        diff = (got.int() - ref.int()).abs()
        out[order] = (diff.ne(0).float().mean().item(), diff.max().item())
    return out


def kernel_shares(d, heads, device, seed):
    """K3 on the card against its twin on the card and on the CPU."""
    from debias_vision_lang_torch.ops.quant import QWeight

    g = torch.Generator().manual_seed(seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(device)

    ls, lb = 1 + 0.1 * rn(d), 0.1 * rn(d)
    wqkv, bqkv, wo, bo = rn(d, 3 * d, std=d ** -0.5), 0.1 * rn(3 * d), rn(d, d, std=d ** -0.5), \
        0.1 * rn(d)
    qkv_w, qo = QWeight(wqkv), QWeight(wo)
    args = (ls, lb, qkv_w.q, qkv_w.scale, bqkv, qo.q, qo.scale, bo)
    x = torch.randn(4, 77, d, generator=torch.Generator().manual_seed(27 + 77)).to(
        device, torch.bfloat16)
    sk, sr, sc = {}, {}, {}
    fbq.attention_block_q(x, *args, heads=heads, wqkv_qt=qkv_w.qt, wo_qt=qo.qt, scratch=sk)
    fbq.attention_block_q_plain(x, *args, heads=heads, scratch=sr)
    fbq.attention_block_q_plain(x.cpu(), *(t.cpu() for t in args), heads=heads, scratch=sc)

    def off(a, b_):
        return (a.cpu().int() - b_.cpu().int()).ne(0).float().mean().item()

    return {"K3 vs card twin": off(sk["aq"], sr["aq"]), "K3 vs CPU twin": off(sk["aq"], sc["aq"]),
            "card twin vs CPU twin": off(sr["aq"], sc["aq"]),
            "K3 attention values off the card twin's": (sk["attn"] != sr["attn"]).float().mean()
            .item(),
            "K3 x codes vs card twin": off(sk["xq"], sr["xq"])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): the order study and K3 on the card; cpu: the "
                         "twin's order study only")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("k3_wide_head_codes: no CUDA device found; pass --device cpu for the "
                 "twin-only order study on the CPU")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU, twin only: no kernel ran")
    for label, d, heads in (("one head of 800", 800, 1), ("12 heads of 64", 768, 12)):
        for order, (sh, worst) in share(d, heads, device, seed=d).items():
            print(f"{label} (D={d}): scores/exp/P V in the {order!r} order: {sh:.3e} of the "
                  f"attention codes differ from the twin's, max |diff| {worst} ({where})")
    if device.type == "cuda":
        for label, d, heads in (("one head of 800", 800, 1), ("one head of 256", 256, 1),
                                ("12 heads of 64", 768, 12)):
            for what, sh in kernel_shares(d, heads, device, seed=d).items():
                print(f"{label} (D={d}) B=4 S=77: {what}: {sh:.3e} ({where})")


if __name__ == "__main__":
    main()
