#!/usr/bin/env python3
"""The port's counterpart of ``benchmarks/attn_int8_cores.py`` (KB (a) 1) on
one CUDA card: int8 Q K^T and P V inside the int8 attention block.

    python3 benchmarks_torch/attn_int8_cores.py [--batch 256] [--steps 30]

A 12-layer ViT-B/16 attention tower (the phase-4 model's resblocks, random
init from seed 0, quantized by ``ops/quant.quantize_resblocks``) on the
script's inputs (``rng.normal(size=(B, 197, 768)) * 0.5`` in bf16):
``attention_block_qq`` against K3 (``attention_block_q``, the script's
"int8-weights block"): the cosine and max |diff| of the two towers' outputs,
then each tower's ms per call (CUDA events), printed as the script prints
them and as JSON lines.  Exits 2 without a card.
"""

import argparse

from kb_common import emit, setup, timeit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    C, fbq, blocks, card = setup("attn_int8_cores")
    xs = C.kb_inputs(args.batch)
    ref_fn, qq_fn = C.kb_int8_tower(fbq, blocks, "k3"), C.kb_int8_tower(fbq, blocks, "qq")
    ref, got = ref_fn(xs[0]).float(), qq_fn(xs[0]).float()
    cos = C.cosine(got, ref)
    diff = (ref - got).abs().max().item()
    print(f"cosine vs int8-weights block: {cos}  max|d|: {diff}")
    t_ref = timeit(ref_fn, xs, args.steps)
    t_qq = timeit(qq_fn, xs, args.steps)
    print(f"int8-weights attn: {t_ref:6.2f} ms   int8-cores attn: {t_qq:6.2f} ms   "
          f"speedup {t_ref / t_qq:.2f}x")
    emit(layers=len(blocks), batch=args.batch, cosine=cos, max_abs_diff=diff,
         int8_weights_attn_ms=t_ref, int8_cores_attn_ms=t_qq, speedup=t_ref / t_qq, card=card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
