#!/usr/bin/env python3
"""Phase 24 of ``chip_smoke.py`` alone: K4's F-split (``mlp_block_q(fb=)``,
KB (a) 7), KB (a) 5 (``attention_block_opt``), the one-call int8 layer of
``benchmarks/q_layer_fused.py`` (``fused_layer_q``) and q_ilp4.py's post-P V
division (``attention_block_q_postdiv``) on one CUDA card, without the
phases before it.

    python3 benchmarks_torch/kb_split_phase.py

Builds the bf16 and int8 kernels (``csrc/fused_block.cu``,
``csrc/fused_block_q.cu``; the SASS checks of phase 2 on both libraries)
and the phase-4 model (ViT-B/16 DebiasCLIP, 2 prepended prompt tokens,
random init from seed 0, full width and depth), then runs
``chip_smoke.split_phase``: each entry against its twin, timed beside K1,
K4 or K3 + K4, and the scripts' 12-layer towers on the model's resblocks.
Prints the kernels line of its rows and the card's nvidia-smi name and
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
        print("kb_split_phase: no CUDA device", file=sys.stderr)
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
    _build.load_all(["fused_block", "fused_block_q"])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for lib in ("fused_block", "fused_block_q"):
        C.print_ptxas(lib, _build.BUILD_LOG.get(lib, ""))
        C.sass_check(lib, _build.LIB_PATHS[lib])
    device = torch.device("cuda")
    model, _, _, _ = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False, "NUM_DEBIAS_TOKENS": 2,
         "DEBIAS_POS": "prepend", "SEED": 0}, device=device)
    model.eval()
    t0 = time.perf_counter()
    rows, wall = C.split_phase(model, card, device)
    print(json.dumps({"kernels": rows}))
    print(f"kb split phase: {wall:.1f} s, {time.perf_counter() - t0:.1f} s wall ({card})")
    print(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as e:
        print(f"kb_split_phase: {e}", file=sys.stderr)
        sys.exit(1)
