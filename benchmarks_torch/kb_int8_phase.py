#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` alone: the int8 kernel experiments of
``benchmarks/`` (KB (a) 1-4) on one CUDA card, without the phases before it.

    python3 benchmarks_torch/kb_int8_phase.py

Builds the int8 kernels (``csrc/fused_block_q.cu`` with the int8 attention
core of ``csrc/attention_qq.cuh``; the SASS check of phase 2 on that
library) and the phase-4 model (ViT-B/16 DebiasCLIP, 2 prepended prompt
tokens, random init from seed 0, full width and depth), then runs
``chip_smoke.kb_int8_phase``: ``attention_block_qq`` and its int8 core,
``mlp_block_q_bf16h``, ``mlp_block_q_var`` at both gelus and
``attention_block_q_var`` against their twins, timed beside K3 / K4, and
the scripts' 12-layer towers on the model's quantized resblocks.  Prints
the kernels line of the four entries and the card's nvidia-smi name and
power limit.  Exits 2 without a card, 1 if a check fails.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kb_int8_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.smi()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.load_all(["fused_block_q"])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    C.print_ptxas("fused_block_q", _build.BUILD_LOG.get("fused_block_q", ""))
    C.sass_check("fused_block_q", _build.LIB_PATHS["fused_block_q"])
    device = torch.device("cuda")
    model, _, _, _ = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False, "NUM_DEBIAS_TOKENS": 2,
         "DEBIAS_POS": "prepend", "SEED": 0}, device=device)
    model.eval()
    t0 = time.perf_counter()
    rows, wall = C.kb_int8_phase(model, card, device)
    print(json.dumps({"kernels": rows}))
    print(f"kb int8 phase: {wall:.1f} s, {time.perf_counter() - t0:.1f} s wall ({card})")
    print(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as e:
        print(f"kb_int8_phase: {e}", file=sys.stderr)
        sys.exit(1)
