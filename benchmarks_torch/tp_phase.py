#!/usr/bin/env python3
"""Phase 22 of ``chip_smoke.py`` alone: tensor parallel on one CUDA card,
without the phases before it.

    python3 benchmarks_torch/tp_phase.py

Builds the kernels and the phase-4 model (ViT-B/16 DebiasCLIP, 2 prepended
prompt tokens, random init from seed 0, full width and depth), then runs
``chip_smoke.tp_phase``: the split entries (``attention_block_heads``,
``mlp_block_cols``, ``tp_reduce`` and their int8 counterparts) and KB (a)
6's ``attention_block_hgrid`` against their twins, timed; the float32,
bf16 and int8 towers under virtual (data, model) meshes of the card
against the unsharded ones; the Frozen-in-Time joint int8 tower on the
long core; the float32 dryrun step.  Prints the kernels line of the split
entries and the card's nvidia-smi name and power limit.  Exits 2 without a
card, 1 if a check fails.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tp_phase: no CUDA device", file=sys.stderr)
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
    rows, wall = C.tp_phase(model, tokenizer or ByteTokenizer(), gen_prompts(), card, device)
    print(json.dumps({"kernels": rows}))
    print(f"tp phase: {wall:.1f} s, {time.perf_counter() - t0:.1f} s wall ({card})")
    print(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as e:
        print(f"tp_phase: {e}", file=sys.stderr)
        sys.exit(1)
