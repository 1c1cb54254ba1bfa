#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone: the port's serving path on one CUDA
card, without the phases before it.

    python3 benchmarks_torch/serve_phase.py

Builds the kernels, the phase-4 model (ViT-B/16 DebiasCLIP, 2 prepended
prompt tokens, random init from seed 0, full width and depth), times its
bf16 image tower at B=256 (the figure phase 16 prints its end-to-end
throughput beside), then runs ``chip_smoke.serve_phase``: the bf16 and the
int8 engine behind the HTTP server, with every check and print of the
smoke's phase 16.  Prints the card's nvidia-smi name and power limit.
Exits 2 without a card, 1 if a check fails.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("serve_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from debias_vision_lang_torch.eval.measure import gen_prompts
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops import _build
    from debias_vision_lang_torch.text import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    card = C.smi()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.load_all(["fused_block", "fused_block_q", "attention"])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    model, _, tokenizer, _ = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False, "NUM_DEBIAS_TOKENS": 2,
         "DEBIAS_POS": "prepend", "SEED": 0}, device="cuda")
    model.eval()
    staged = torch.randint(0, 256, (C.BATCH, 196, 768), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0)).cuda()
    with torch.no_grad():
        ms = C.cuda_ms(lambda: model.encode_image(staged, dtype=torch.bfloat16), iters=5)
    tower = C.BATCH / ms * 1e3
    print(f"image tower B={C.BATCH} kernels (bf16): {ms:.3f} ms/batch, {tower:.1f} img/s "
          f"({card})")
    t0 = time.perf_counter()
    C.serve_phase(model, tokenizer or ByteTokenizer(), gen_prompts(), card, tower)
    print(f"serving phase wall {time.perf_counter() - t0:.1f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
