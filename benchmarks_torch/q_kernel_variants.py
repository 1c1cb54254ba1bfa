#!/usr/bin/env python3
"""The port's counterpart of ``benchmarks/q_kernel_variants.py`` (KB (a) 3
and 4) on one CUDA card: the int8 blocks with the reciprocal quantizer.

    python3 benchmarks_torch/q_kernel_variants.py [--batch 512] [--steps 10]

12-layer ViT-B/16 MLP and attention towers (the phase-4 model's resblocks,
random init from seed 0, quantized by ``ops/quant.quantize_resblocks``) on
the script's inputs (two buffers of ``rng.normal(size=(B, 197, 768)) *
0.5`` in bf16).  MLP: A, K4 (``mlp_block_q``); B, ``mlp_block_q_var``;
C, the same with the bf16 quick_gelu.  Attention: A, K3
(``attention_block_q``); B, ``attention_block_q_var``; C, the script's
head-pair packing, a TPU lane layout of the same products: the card runs
B's kernel again.  Prints the script's JSON keys: each tower's ms per call
(CUDA events) and each variant's cosine against A's tower.  Exits 2
without a card.
"""

import argparse

from kb_common import emit, setup, timeit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    C, fbq, blocks, card = setup("q_kernel_variants")
    xs = C.kb_inputs(args.batch)
    towers = {k: C.kb_int8_tower(fbq, blocks, k)
              for k in ("k4", "mlp_var", "mlp_var_bf16_gelu", "k3", "attn_var")}
    ref_mlp, ref_attn = towers["k4"](xs[0]).float(), towers["k3"](xs[0]).float()
    emit(mlp_A_baseline_ms=timeit(towers["k4"], xs, args.steps))
    for name, kind in (("B_recip", "mlp_var"), ("C_recip_bf16gelu", "mlp_var_bf16_gelu")):
        emit(**{f"mlp_{name}_ms": timeit(towers[kind], xs, args.steps)})
        emit(**{f"mlp_{name}_cos": C.cosine(towers[kind](xs[0]).float(), ref_mlp)})
    emit(attn_A_baseline_ms=timeit(towers["k3"], xs, args.steps))
    for name in ("B_recip_exp2_postdiv", "C_headpair"):
        emit(**{f"attn_{name}_ms": timeit(towers["attn_var"], xs, args.steps)})
        emit(**{f"attn_{name}_cos": C.cosine(towers["attn_var"](xs[0]).float(), ref_attn)})
    emit(layers=len(blocks), batch=args.batch, card=card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
