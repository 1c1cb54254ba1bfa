#!/usr/bin/env python3
"""The port's counterpart of ``benchmarks/q_mlp_bf16h.py`` (KB (a) 2) on one
CUDA card: K4 with the hidden stored in bf16 between the up-projection and
quick_gelu / quantize.

    python3 benchmarks_torch/q_mlp_bf16h.py [--batch 512] [--steps 10]

A 12-layer ViT-B/16 MLP tower (the phase-4 model's resblocks, random init
from seed 0, quantized by ``ops/quant.quantize_resblocks``) on the script's
inputs (two buffers of ``rng.normal(size=(B, 197, 768)) * 0.5`` in bf16):
K4 (``mlp_block_q``) as ``mlp_base_ms``, then ``mlp_block_q_bf16h`` under
each of the script's names.  Its ``bb`` (batch items per grid step) and
``depth`` (up-projections in flight) are the TPU kernel's chain schedule
and do not change the function: the card runs the one kernel for each
name, timed again (a name whose bb does not divide the batch is skipped,
as the script skips it).  Prints the script's JSON keys, ms and cosine
against K4's tower.  Exits 2 without a card.
"""

import argparse

from kb_common import emit, setup, timeit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    C, fbq, blocks, card = setup("q_mlp_bf16h")
    xs = C.kb_inputs(args.batch)
    base = C.kb_int8_tower(fbq, blocks, "k4")
    ref = base(xs[0]).float()
    emit(mlp_base_ms=timeit(base, xs, args.steps))
    fn = C.kb_int8_tower(fbq, blocks, "bf16h")
    for name, bb, depth in (("bb4_d2_bf16h", 4, 2), ("bb6_d2_bf16h", 6, 2),
                            ("bb4_d3_bf16h", 4, 3)):
        if args.batch % bb:
            continue
        emit(**{f"mlp_{name}_ms": timeit(fn, xs, args.steps),
                f"mlp_{name}_cos": C.cosine(fn(xs[0]).float(), ref)})
    emit(layers=len(blocks), batch=args.batch, card=card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
