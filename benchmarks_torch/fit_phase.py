#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` alone: the Frozen-in-Time video family
(ViT-B/16 over 4 frames at full width and depth, joint and divided) on one
CUDA card, without the phases before it.

    python3 benchmarks_torch/fit_phase.py

Builds the kernels (the int8 towers run K3 + K4: the joint one's K3 on its
long core at S = 785, the divided one's at S = 196; the text tower K1 / K2
at bfloat16, K3 / K4 under "int8-text"; ``use_pallas`` K5), prints nvcc's
register report and checks each library's long-route SASS, then runs
``chip_smoke.fit_phase``: 256 written videos (frame directories and GIFs)
through measure_bias(dataset="video") at float32, bfloat16, int8 and
int8-text for both formulations (metrics against the numpy oracle,
cosines against float32, launch counts and core routes, videos/s and
frames/s), use_pallas on the towers, the float32 witness against the CPU
port, an m-bain-named checkpoint through model_loader and the embedding
cache's formulation key, with every check and print of the smoke's phase
19.  Prints the card's nvidia-smi name and power limit.  Exits 2 without a
card, 1 if a check fails.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fit_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from debias_vision_lang_torch.eval.measure import gen_prompts
    from debias_vision_lang_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.smi()
    print(f"card: {card}")
    t0 = time.perf_counter()
    libs = ["fused_block", "fused_block_q", "attention"]
    _build.load_all(libs)
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {_build.BUILD_SECONDS})")
    for lib in libs:
        C.print_ptxas(lib, _build.BUILD_LOG.get(lib, ""))
        C.sass_check_long(lib, _build.LIB_PATHS[lib])
    t0 = time.perf_counter()
    launches = C.fit_phase(gen_prompts(), card, torch.device("cuda"))
    print(f"int8 joint measurement's launches {launches}; phase 19 wall "
          f"{time.perf_counter() - t0:.1f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
