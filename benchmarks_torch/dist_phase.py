#!/usr/bin/env python3
"""Phase 20 of ``chip_smoke.py`` alone: the port's distribution path on one
CUDA card, without the phases before it.

    python3 benchmarks_torch/dist_phase.py

Builds the kernels and the phase-4 model (ViT-B/16 DebiasCLIP, 2 prepended
prompt tokens, random init from seed 0, full width and depth) and its int8
wrap, then runs ``chip_smoke.dist_phase``: measure_bias with mesh="auto",
a virtual 4-way mesh on the one card (embeds, sharded metrics with planted
ties, zero-shot, the serving engine, the trainer) and a two-rank gloo world
on the card, with every check and print of the smoke's phase 20.  Prints the
card's nvidia-smi name and power limit.  Exits 2 without a card, 1 if a
check fails.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dist_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from debias_vision_lang_torch.eval.measure import gen_prompts
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops import _build
    from debias_vision_lang_torch.ops.quant import resolve_compute
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
    qmodel, _ = resolve_compute(model, "int8")
    t0 = time.perf_counter()
    wall = C.dist_phase(model, qmodel, tokenizer or ByteTokenizer(), gen_prompts(), card,
                        device)
    print(f"distribution phase: {wall:.1f} s of sub-phases, {time.perf_counter() - t0:.1f} s "
          f"wall ({card})")
    print(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as e:
        print(f"dist_phase: {e}", file=sys.stderr)
        sys.exit(1)
