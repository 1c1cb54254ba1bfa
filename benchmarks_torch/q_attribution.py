#!/usr/bin/env python3
"""The port's counterpart of ``benchmarks/q_attribution.py`` (KB (c)) on one
CUDA card: the int8 attention and MLP blocks with one side stubbed out, to
see whether the products and the elementwise chain run in series (full ~=
mxu + vpu) or overlap (full ~= max(mxu, vpu)).

    python3 benchmarks_torch/q_attribution.py [--batch 512] [--steps 10]

Six 12-layer ViT-B/16 towers (the phase-4 model's resblocks, random init
from seed 0, quantized by ``ops/quant.quantize_resblocks``) on the script's
inputs (two buffers of ``rng.normal(size=(B, 197, 768)) * 0.5`` in bf16),
in the script's order: ``mlp_block_q_attr`` and ``attention_block_q_attr``
at mode "full" (K4 / K3), "mxu" (the products only) and "vpu" (the
elementwise chain only, each product a broadcast).  Prints the script's
JSON keys (``{mlp,attn}_{full,mxu,vpu}_ms``: ms per tower call, CUDA
events), then per block full / (mxu + vpu) and full / max(mxu, vpu), and
the card's nvidia-smi name and power limit.  Exits 2 without a card.
"""

import argparse

from kb_common import emit, setup, timeit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    C, fbq, blocks, card = setup("q_attribution")
    xs = C.kb_inputs(args.batch)
    ms = {}
    for kind in C.ATTR_KINDS:
        ms[kind] = timeit(C.kb_int8_tower(fbq, blocks, kind, kinds=C.ATTR_KINDS), xs, args.steps)
        emit(**{f"{kind}_ms": ms[kind]})
    for blk in ("mlp", "attn"):
        full, mxu, vpu = (ms[f"{blk}_{mode}"] for mode in ("full", "mxu", "vpu"))
        emit(**{f"{blk}_full_over_sum": full / (mxu + vpu),
                f"{blk}_full_over_max": full / max(mxu, vpu)})
    emit(layers=len(blocks), batch=args.batch, card=card)
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
