#!/usr/bin/env python3
"""The port's counterpart of ``benchmarks/q_layer_fused.py`` on one CUDA
card: a whole int8 layer in one call.

    python3 benchmarks_torch/q_layer_fused.py [--batch 512] [--steps 10]

A 12-layer ViT-B/16 int8 tower (the phase-4 model's resblocks, random init
from seed 0, quantized by ``ops/quant.quantize_resblocks``) on the
script's inputs (two buffers of ``rng.normal(size=(B, 197, 768)) * 0.5``
in bf16): base, K3 then K4 per layer (``fused_resblock_q``); layer,
``fused_layer_q`` (the script's ``layer_kernel``: x + proj kept f32
between the halves).  Its modes seq, xpipe and prod are TPU issue orders
of one function: the card runs the one call for each.  Prints the
script's JSON keys: each tower's ms per call (CUDA events) and the
layer's cosine against base.  Exits 2 without a card.
"""

import argparse

from kb_common import emit, setup, timeit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    C, fbq, blocks, card = setup("q_layer_fused")
    heads = C.KB_H

    def base(x):
        for blk in blocks:
            x = fbq.fused_resblock_q(blk, x, heads)
        return x

    def layer(x):
        for blk in blocks:
            x = fbq.fused_layer_q(
                x, blk.ln_1.scale, blk.ln_1.bias, blk.wqkv.q, blk.wqkv.scale, blk.bqkv,
                blk.wo.q, blk.wo.scale, blk.bo, blk.ln_2.scale, blk.ln_2.bias, blk.w1.q,
                blk.w1.scale, blk.b1, blk.w2.q, blk.w2.scale, blk.b2, heads=heads,
                wqkv_qt=blk.wqkv.qt, wo_qt=blk.wo.qt, w1_qt=blk.w1.qt, w2_qt=blk.w2.qt)
        return x

    xs = C.kb_inputs(args.batch)
    ref = base(xs[0]).float()
    emit(scoped_vmem_kib="default", layer_base_ms=timeit(base, xs, args.steps))
    for name in ("seq_bb2", "xpipe_bb2", "seq_bb4"):
        emit(**{f"layer_{name}_ms": timeit(layer, xs, args.steps),
                f"layer_{name}_cos": C.cosine(layer(xs[0]).float(), ref)})
    emit(layers=len(blocks), batch=args.batch, card=card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
