#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` alone: the ModifiedResNet family (RN50 and
RN50x4 at full width and depth) on one CUDA card, without the phases before
it.

    python3 benchmarks_torch/resnet_phase.py

Builds the kernels (the text towers run K1 / K2 at bfloat16 and K3 / K4
under "int8-text"), then runs ``chip_smoke.resnet_phase``: each tower through
the measurement pipeline at float32, bfloat16, int8 and int8-text (metrics
against the numpy oracle, cosines against float32, launch counts, img/s
and the int8 tower's split), the TF32 witness, RN50's OpenAI-named
checkpoint and its bf16 serving engine, with every check and print of the
smoke's phase 18.  Prints the card's nvidia-smi name and power limit.
Exits 2 without a card, 1 if a check fails.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("resnet_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from debias_vision_lang_torch.eval.measure import gen_prompts
    from debias_vision_lang_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = C.smi()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.load_all(["fused_block", "fused_block_q", "attention"])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches = C.resnet_phase(gen_prompts(), card, torch.device("cuda"))
    print(f"RN50x4 text-tower launches {launches}; phase 18 wall "
          f"{time.perf_counter() - t0:.1f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
