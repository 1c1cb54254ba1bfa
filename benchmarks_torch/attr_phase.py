#!/usr/bin/env python3
"""Phase 25 of ``chip_smoke.py`` alone: the MXU-only and VPU-only int8 blocks
of ``benchmarks/q_attribution.py`` (``mlp_block_q_attr``,
``attention_block_q_attr``) on one CUDA card, without the phases before it.

    python3 benchmarks_torch/attr_phase.py

Builds the int8 kernels (``csrc/fused_block_q.cu``; the SASS checks of
phase 2 on that library) and the phase-4 model (ViT-B/16 DebiasCLIP, 2
prepended prompt tokens, random init from seed 0, full width and depth),
then runs ``chip_smoke.attr_phase``: the attribution's SASS checks, each
"mxu" / "vpu" kernel against its twin and timed beside K3 / K4, and the
script's six 12-layer towers on the model's resblocks at B=512.  Prints the
kernels line of its rows and the card's nvidia-smi name and power limit.
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
        print("attr_phase: no CUDA device", file=sys.stderr)
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
    C.sass_check_long("fused_block_q", _build.LIB_PATHS["fused_block_q"])
    device = torch.device("cuda")
    model, _, _, _ = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False, "NUM_DEBIAS_TOKENS": 2,
         "DEBIAS_POS": "prepend", "SEED": 0}, device=device)
    model.eval()
    t0 = time.perf_counter()
    rows, wall = C.attr_phase(model, card, device)
    print(json.dumps({"kernels": rows}))
    print(f"attr phase: {wall:.1f} s, {time.perf_counter() - t0:.1f} s wall ({card})")
    print(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as e:
        print(f"attr_phase: {e}", file=sys.stderr)
        sys.exit(1)
