#!/usr/bin/env python3
"""K5's long route (``ops/attention.py::attention_pallas``, csrc/attention.cu)
timed at wide head dims on one CUDA card, so that two checkouts of the port
can be compared in one run.

At B=8, H=12 (a Frozen-in-Time joint tower's batch and heads), S = 77 and
785, a zero mask, bfloat16 and float32, for each head dim asked: the time of
one ``attention_pallas`` call (CUDA events over 20 calls after a warm-up,
the wrapper's copies included), the launches it counted, the largest
difference from ``attention_kernel_math`` (the twin) on the same inputs on
the card, the twin's time, the time of one
``torch.nn.functional.scaled_dot_product_attention`` call on the same
inputs (SDPA, the library's yardstick), and the bound: the larger of the
operations over the card's dense peak (bf16, or three TF32 products per
f32 product) and the bytes over 3.35 TB/s (``chip_smoke.py::attention_work``
and ``bound``).  A head dim the checkout refuses prints "refused" with its
message.

    python3 benchmarks_torch/k5_head_dim_times.py [--root CHECKOUT] [--hd 192 256 800]
        [--dump DIR | --against DIR]

``--root`` imports ``debias_vision_lang_torch`` from another checkout (for
example a parent commit unpacked with ``git archive``); its kernels build
under that checkout.  ``--dump`` saves every output to DIR; ``--against``
compares every output with the one saved there (the inputs are made from
the same seeds on the card) and prints whether the two are bit-identical
and their largest difference.  Prints the card's nvidia-smi name and power
limit.  Exits 2 without a card.
"""

import argparse
import os
import subprocess
import sys

PEAK = {"bf16": 989e12, "tf32": 494.7e12}  # H100 SXM dense, operations a second
HBM_BYTES_PER_S = 3.35e12


def bound_ms(b, h, s, hd, f32):
    """(ms, what bounds it) for one call at the true head dim."""
    flops = 4 * b * h * s * s * hd
    t_ops = (3 * flops / PEAK["tf32"]) if f32 else flops / PEAK["bf16"]
    t_bytes = (4 * b * h * s * hd * (4 if f32 else 2) + s * s * 4) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=here, help="the checkout whose port is timed")
    ap.add_argument("--hd", type=int, nargs="+", default=[192, 256, 800])
    ap.add_argument("--label", default="", help="a tag printed on every line")
    ap.add_argument("--dump", help="save each output to this directory")
    ap.add_argument("--against", help="compare each output with the one saved here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k5_head_dim_times: no CUDA device found", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from debias_vision_lang_torch.ops import attention as att

    dev = torch.device("cuda")
    name = card()
    b, h = 8, 12
    for hd in args.hd:
        for s in (77, 785):
            for dt in (torch.bfloat16, torch.float32):
                g = torch.Generator(device=dev).manual_seed(hd * 1000 + s)
                q, k, v = (torch.randn(b, h, s, hd, generator=g, device=dev).to(dt)
                           for _ in range(3))
                tag = f"{args.label} hd={hd} S={s} {str(dt)[6:]}"
                try:
                    att.reset_launches()
                    out = att.attention_pallas(q, k, v)
                    torch.cuda.synchronize()
                except (ValueError, RuntimeError) as e:
                    print(f"{tag}: refused: {str(e).splitlines()[0]} ({name})")
                    continue
                launches = {**att.LAUNCHES, **getattr(att, "WIDE_LAUNCHES", {})}
                ref = att.attention_kernel_math(q, k, v, att._zero_mask(q))
                err = (out.float() - ref.float()).abs().max().item()
                key = f"hd{hd}_s{s}_{str(dt)[6:]}.pt"
                same = ""
                if args.dump:
                    os.makedirs(args.dump, exist_ok=True)
                    torch.save(out.cpu(), os.path.join(args.dump, key))
                if args.against:
                    other = torch.load(os.path.join(args.against, key)).to(dev)
                    diff = (out.float() - other.float()).abs().max().item()
                    same = (f", against {args.against}: "
                            f"{'bit-identical' if torch.equal(out, other) else 'differs'} "
                            f"(max |diff| {diff:.3e})")
                    del other
                zero = att._zero_mask(q).to(dt)
                times = []
                for fn in (lambda: att.attention_pallas(q, k, v),
                           lambda: att.attention_kernel_math(q, k, v, att._zero_mask(q)),
                           lambda: torch.nn.functional.scaled_dot_product_attention(
                               q, k, v, attn_mask=zero)):
                    fn()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    start.record()
                    for _ in range(20):
                        fn()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) / 20)
                bms, by = bound_ms(b, h, s, hd, dt == torch.float32)
                print(f"{tag}: kernel {times[0]:.4f} ms, twin {times[1]:.4f} ms, SDPA "
                      f"{times[2]:.4f} ms, bound {bms:.4f} ms ({by}; {bms / times[0]:.1%}), "
                      f"max |err| {err:.3e}, launches {launches}{same} ({name})", flush=True)
                del q, k, v, out, ref, zero
    return 0


if __name__ == "__main__":
    sys.exit(main())
