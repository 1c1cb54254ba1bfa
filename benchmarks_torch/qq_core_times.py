#!/usr/bin/env python3
"""KB (a) 1's int8 attention core (``ops/fused_block_q.py::attention_qq_core``,
csrc/attention_qq.cuh) and its block (``attention_block_qq``) timed on one
CUDA card beside K3 (``attention_block_q``) at the same shapes, so that two
checkouts of the port can be compared in one run.

Shapes (B, S, D, H): 256 197 768 12 (ViT-B/16 at the main path's batch, the
core's register route), 32 785 768 12 (the int8 joint Frozen-in-Time
tower's attention, the tiled route), and chip_smoke.py phase 27's B=2 shapes
(S 257 and 785 at D 768, S 197 at D 960: head dim 80).  For each: the time
of one core call on a seeded f32 qkv and of one block call on a seeded bf16
x (CUDA events over 20 calls after a warm-up, the wrappers' allocations
included), the route and launches counted, the largest difference from the
twins (``attention_qq_core_plain``, ``attention_block_qq_plain``) on the
card, K3's time on the same x, the device kernels of the qq core, the qq
block and K3 (``torch.profiler``: each kernel's ms per call, K3's core among
them), and the bound: the larger of the int8 operations (Q K^T and P V at
the true head dim) over 1,979 TOP/s and the bytes (the f32 qkv read, the
bf16 output written) over 3.35 TB/s.

    python3 benchmarks_torch/qq_core_times.py [--root CHECKOUT] [--label TAG]
        [--shapes 0 1 ...] [--dump DIR | --against DIR [--scratch]]

``--root`` imports ``debias_vision_lang_torch`` from another checkout (for
example a parent commit unpacked with ``git archive``); its kernels build
under that checkout.  ``--dump`` saves each core and block output to DIR;
``--against`` compares each with the one saved there (the inputs come from
the same seeds on the card) and prints whether they are bit-identical (how
many elements differ if not); ``--scratch`` adds the core's p, its codes
and its row scales to both.
Prints the card's nvidia-smi name and power limit.  Exits 2 without a card.
"""

import argparse
import os
import re
import subprocess
import sys

SHAPES = ((256, 197, 768, 12), (32, 785, 768, 12), (2, 257, 768, 12), (2, 785, 768, 12),
          (2, 197, 960, 12))
INT8_PEAK = 1979e12  # H100 SXM dense int8, operations a second
HBM_BYTES_PER_S = 3.35e12


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def core_bound_ms(b, s, d):
    """(ms, what bounds it) of the core: 4 B S^2 D int8 operations against the
    f32 qkv read and the bf16 output written once."""
    t_ops = 4 * b * s * s * d / INT8_PEAK
    t_bytes = (b * s * 3 * d * 4 + b * s * d * 2) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def events_ms(fn, iters=20):
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def kernel_split(fn, iters=5):
    """[(short kernel name, ms per call)] of fn's device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            m = re.match(r"^(?:void )?(?:\(anonymous namespace\)::)?([\w]+(?:<[^()]*>)?)", ev.key)
            parts.append((m.group(1) if m else ev.key[:60], us / iters / 1e3))
    return sorted(parts, key=lambda p: -p[1])


def fmt_split(parts):
    return "; ".join(f"{n} {ms:.4f} ms" for n, ms in parts) + \
        f"; sum {sum(ms for _, ms in parts):.4f} ms"


def block_params(d, dev, seed, QWeight):
    """Unit-gain random block weights (as chip_smoke.py's block_params), the
    two projections quantized per output channel."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    ls, lb = 1 + 0.1 * rn(d), 0.1 * rn(d)
    wqkv, bqkv = QWeight(rn(d, 3 * d, std=d ** -0.5)), 0.1 * rn(3 * d)
    wo, bo = QWeight(rn(d, d, std=d ** -0.5)), 0.1 * rn(d)
    return ((ls, lb, wqkv.q, wqkv.scale, bqkv, wo.q, wo.scale, bo),
            {"wqkv_qt": wqkv.qt, "wo_qt": wo.qt})


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=here, help="the checkout whose port is timed")
    ap.add_argument("--label", default="", help="a tag printed on every line")
    ap.add_argument("--shapes", type=int, nargs="+", default=list(range(len(SHAPES))),
                    help="indices into SHAPES")
    ap.add_argument("--dump", help="save each output to this directory")
    ap.add_argument("--against", help="compare each output with the one saved here")
    ap.add_argument("--scratch", action="store_true",
                    help="with --dump / --against, also the core's p, p codes and p scales")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("qq_core_times: no CUDA device found", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.ops.quant import QWeight

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name = card()
    tag0 = f"{args.label} " if args.label else ""
    for i in args.shapes:
        b, s, d, h = SHAPES[i]
        shape = f"B={b} S={s} D={d} H={h} hd={d // h}"
        g = torch.Generator(device=dev).manual_seed(1000 * s + d)
        qkv = torch.randn(b, s, 3 * d, generator=g, device=dev)
        x = (torch.randn(b, s, d, generator=g, device=dev) * 0.5).to(torch.bfloat16)
        blk, blk_kw = block_params(d, dev, seed=s + d, QWeight=QWeight)
        fbq.reset_launches()
        core = fbq.attention_qq_core(qkv, h)
        torch.cuda.synchronize()
        routes, launches = dict(fbq.QQ_ROUTES), fbq.KB_LAUNCHES["attention_qq_core"]
        block = fbq.attention_block_qq(x, *blk, heads=h, **blk_kw)
        torch.cuda.synchronize()
        core_err = (core.float() - fbq.attention_qq_core_plain(qkv, h, torch.bfloat16).float()
                    ).abs().max().item()
        block_err = (block.float() - fbq.attention_block_qq_plain(x, *blk, heads=h).float()
                     ).abs().max().item()
        same = ""
        outs = [("core", core), ("block", block)]
        if args.scratch:
            sk = {}
            fbq.attention_qq_core(qkv, h, scratch=sk)
            outs += [(f"core {k}", sk[k]) for k in ("p", "pq", "psc")]
        for what, out in outs:
            key = f"{what.replace(' ', '_')}_b{b}_s{s}_d{d}.pt"
            if args.dump:
                os.makedirs(args.dump, exist_ok=True)
                torch.save(out.cpu(), os.path.join(args.dump, key))
            if args.against:
                other = torch.load(os.path.join(args.against, key)).to(dev)
                diff = (out.float() - other.float()).abs().max().item()
                n = int((out != other).sum())
                same += (f"; {what} against {args.against}: "
                         f"{'bit-identical' if torch.equal(out, other) else f'{n} differ'} "
                         f"(max |diff| {diff:.3e})")
        t_core = events_ms(lambda: fbq.attention_qq_core(qkv, h))
        t_block = events_ms(lambda: fbq.attention_block_qq(x, *blk, heads=h, **blk_kw))
        t_k3 = events_ms(lambda: fbq.attention_block_q(x, *blk, heads=h, **blk_kw))
        bms, by = core_bound_ms(b, s, d)
        print(f"{tag0}{shape}: core {t_core:.4f} ms (routes {routes}, launches {launches}; bound "
              f"{bms:.4f} ms, {by}, {bms / t_core:.1%}; max |err| vs twin {core_err:.3e}), "
              f"block {t_block:.4f} ms (max |err| {block_err:.3e}), K3 block {t_k3:.4f} ms"
              f"{same} ({name})", flush=True)
        print(f"{tag0}{shape} split core: "
              f"{fmt_split(kernel_split(lambda: fbq.attention_qq_core(qkv, h)))} ({name})")
        print(f"{tag0}{shape} split qq block: "
              f"{fmt_split(kernel_split(lambda: fbq.attention_block_qq(x, *blk, heads=h, **blk_kw)))}"
              f" ({name})")
        print(f"{tag0}{shape} split K3 block: "
              f"{fmt_split(kernel_split(lambda: fbq.attention_block_q(x, *blk, heads=h, **blk_kw)))}"
              f" ({name})", flush=True)
        del qkv, x, core, block, blk, blk_kw
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
