#!/usr/bin/env python3
"""The port's counterpart of ``benchmarks/attn_variants.py`` (KB (a) 5 and
6) on one CUDA card: the bf16 attention block in three forms.

    python3 benchmarks_torch/attn_variants.py [cur|opt|hgrid|all] [--batch 256] [--steps 30]

A 12-layer ViT-B/16 attention tower (the phase-4 model's resblocks, random
init from seed 0) on the KB scripts' inputs (``rng.normal(size=(B, 197,
768)) * 0.5`` in bf16): cur, K1 (``fused_block.attention_block``); opt,
``attention_block_opt`` on each block's weights through ``prescale_qkv``;
hgrid, ``attention_block_hgrid`` on the per-head blocks the script builds.
The script's ``bb`` is a TPU chain width: the card runs one kernel each.
Prints each tower's ms (CUDA events), opt's and hgrid's max |diff| against
cur, and the results as one JSON line.  Exits 2 without a card.
"""

import argparse

from kb_common import emit, setup, timeit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="all", choices=("all", "cur", "opt", "hgrid"))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    C, fb, blocks, card = setup("attn_variants", float_blocks=True)
    import torch
    from debias_vision_lang_torch.ops.fused_block import _block_args

    d, heads = C.KB_D, C.KB_H
    args_of = [_block_args(blk)[0] for blk in blocks]
    opt_of = [(ls, lb, *fb.prescale_qkv(w.detach(), b.detach(), d, heads), wo, bo)
              for ls, lb, w, b, wo, bo in args_of]
    hgrid_of = [C.hgrid_operands(tuple(t.detach() for t in a), heads) for a in args_of]
    towers = {"cur": (fb.attention_block, args_of), "opt": (fb.attention_block_opt, opt_of),
              "hgrid": (fb.attention_block_hgrid, hgrid_of)}

    def tower(kind):
        fn, ops = towers[kind]

        def run(x):
            for a in ops:
                x = fn(x, *a, heads=heads)
            return x
        return run

    xs = C.kb_inputs(args.batch)
    results = {}
    with torch.no_grad():
        ref = tower("cur")(xs[0]).float()
        for kind in ("cur", "opt", "hgrid"):
            if args.which not in ("all", kind):
                continue
            results[f"{kind}_ms"] = timeit(tower(kind), xs, args.steps)
            print(f"{kind}: {results[f'{kind}_ms']:.2f} ms/tower", flush=True)
            if kind != "cur":
                got = tower(kind)(xs[0]).float()
                results[f"{kind}_max_abs_diff"] = (got - ref).abs().max().item()
                results[f"{kind}_cos"] = C.cosine(got, ref)
                print(f"{kind} max|diff| vs cur: {results[f'{kind}_max_abs_diff']:.5f}")
    emit(**results, layers=len(blocks), batch=args.batch, card=card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
