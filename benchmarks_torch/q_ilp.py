#!/usr/bin/env python3
"""The port's counterpart of ``benchmarks/q_ilp.py`` (KB (a) 7 and the (b)
site ``bb2_call``) on one CUDA card: the int8 MLP block with its hidden
split into F-chunks.

    python3 benchmarks_torch/q_ilp.py [--batch 512] [--steps 10]

12-layer ViT-B/16 MLP towers (the phase-4 model's resblocks, random init
from seed 0, quantized by ``ops/quant.quantize_resblocks``) on the script's
inputs (two buffers of ``rng.normal(size=(B, 197, 768)) * 0.5`` in bf16):
base, K4 (``mlp_block_q``); fsplit2 and fsplit4, ``mlp_block_q(fb=F/2)``
and ``(fb=F/4)`` (the script's ``make_fsplit(k)``: each F-chunk quantized
with its own row scales, the chunks' products summed in f32); bb2, the
script's two explicit batch chains, a TPU issue order of K4's function:
the card runs K4 itself.  Prints the script's JSON keys: each tower's ms
per call (CUDA events) and each variant's cosine against base.  Exits 2
without a card.
"""

import argparse

from kb_common import emit, setup, timeit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    C, fbq, blocks, card = setup("q_ilp")
    xs = C.kb_inputs(args.batch)
    towers = {k: C.kb_int8_tower(fbq, blocks, k, kinds=C.SPLIT_KINDS)
              for k in ("k4", "fsplit2", "fsplit4")}
    ref = towers["k4"](xs[0]).float()
    emit(mlp_base_ms=timeit(towers["k4"], xs, args.steps))
    for k in (2, 4):
        fn = towers[f"fsplit{k}"]
        emit(**{f"mlp_fsplit{k}_ms": timeit(fn, xs, args.steps),
                f"mlp_fsplit{k}_cos": C.cosine(fn(xs[0]).float(), ref)})
    emit(mlp_bb2_interleave_ms=timeit(towers["k4"], xs, args.steps),
         mlp_bb2_cos=C.cosine(towers["k4"](xs[0]).float(), ref))
    emit(layers=len(blocks), batch=args.batch, card=card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
