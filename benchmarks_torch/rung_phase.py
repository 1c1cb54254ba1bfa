#!/usr/bin/env python3
"""Phase 21 of ``chip_smoke.py`` alone: the "auto" rung on one CUDA card,
without the phases before it.

    python3 benchmarks_torch/rung_phase.py

Builds the kernels and the phase-4 model (ViT-B/16 DebiasCLIP, 2 prepended
prompt tokens, random init from seed 0, full width and depth), then runs
``chip_smoke.rung_phase``: K1-K4 against their twins at the shapes of
ViT-B/32 (S = 50), ViT-L/14 (S = 257, D = 1024, and its D = 768 text tower);
ViT-B/32, ViT-L/14, SLIP-ViT-B/16 and RN101 at full width and depth at every
rung (img/s at B = 256, CUDA events; rows against float32); and
``dtype="auto"`` through measure_bias (ViT-B/16, SLIP-B/16, RN50, the
Frozen-in-Time joint tower), the serving engine, zero-shot and the CLI,
with every check and print of the smoke's phase 21.  Prints the kernels
line of the new shapes and the card's nvidia-smi name and power limit.
Exits 2 without a card, 1 if a check fails.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("rung_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from debias_vision_lang_torch.eval.measure import gen_prompts
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops import _build
    from debias_vision_lang_torch.text import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.smi()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.load_all(["fused_block", "fused_block_q", "attention"])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    device = torch.device("cuda")
    model, _, tokenizer, _ = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False, "NUM_DEBIAS_TOKENS": 2,
         "DEBIAS_POS": "prepend", "SEED": 0}, device=device)
    model.eval()
    t0 = time.perf_counter()
    rows, wall = C.rung_phase(model, tokenizer or ByteTokenizer(), gen_prompts(), card, device)
    print(json.dumps({"kernels": rows}))
    print(f"rung phase: {wall:.1f} s of sub-phases, {time.perf_counter() - t0:.1f} s wall "
          f"({card})")
    print(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as e:
        print(f"rung_phase: {e}", file=sys.stderr)
        sys.exit(1)
