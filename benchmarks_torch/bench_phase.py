#!/usr/bin/env python3
"""Phase 26 of ``chip_smoke.py`` alone: the port's bench
(``benchmarks_torch/bench.py``) on one CUDA card, without the phases before
it.

    python3 benchmarks_torch/bench_phase.py

Builds the three kernel libraries (one nvcc each, started together), then
runs ``chip_smoke.bench_phase``: the root bench.py's six configurations
through ``bench.run`` with their records, launches and rows against
float32's, the headline at B = 256, 512, 1024, and ``python -m
debias_vision_lang_torch bench`` in a subprocess.  Prints the card's
nvidia-smi name and power limit last.  Exits 2 without a card, 1 if a check
fails.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from debias_vision_lang_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.smi()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.load_all(["fused_block", "fused_block_q", "attention"])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    wall = C.bench_phase(card, torch.device("cuda"))
    print(f"bench phase: {wall:.1f} s ({card})")
    print(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as e:
        print(f"bench_phase: {e}", file=sys.stderr)
        sys.exit(1)
