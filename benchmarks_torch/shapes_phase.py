#!/usr/bin/env python3
"""Phase 27 of ``chip_smoke.py`` alone: K1-K4 at the shapes of public
models' widths that the JAX kernels take (SigLIP-So400m's head dim 72 at
S = 257 and on the long core at S = 729, ViT-H/14's head dim 80 and F =
5,120, bigG/14's head dim 104 and F = 8,192, D = 200 off every tile, K4's
F-split at fb = F / 4) against their twins, timed against the bound of the
true work, and a tower from a CLIPConfig at ViT-H/14's widths at bf16 and
int8, on one CUDA card, without the phases before it.

    python3 benchmarks_torch/shapes_phase.py

Builds the bf16 and int8 kernels (``csrc/fused_block.cu``,
``csrc/fused_block_q.cu``; the SASS checks of phase 2 on both libraries),
then runs ``chip_smoke.shape_phase``.  Prints the kernels line of its rows
and the card's nvidia-smi name and power limit.  Exits 2 without a card, 1
if a check fails.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("shapes_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from debias_vision_lang_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.smi()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.load_all(["fused_block", "fused_block_q"])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for lib in ("fused_block", "fused_block_q"):
        C.print_ptxas(lib, _build.BUILD_LOG.get(lib, ""))
        C.sass_check(lib, _build.LIB_PATHS[lib])
        C.sass_check_long(lib, _build.LIB_PATHS[lib])
    rows, wall = C.shape_phase(card, torch.device("cuda"))
    print(json.dumps({"kernels": rows}))
    print(f"shapes phase: {wall:.1f} s ({card})")
    print(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as e:
        print(f"shapes_phase: {e}", file=sys.stderr)
        sys.exit(1)
