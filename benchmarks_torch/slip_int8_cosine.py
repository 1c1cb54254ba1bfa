#!/usr/bin/env python3
"""Where the int8 rung's distance from float32 comes from, on one CUDA card:
the int8 kernels, or the rung's own arithmetic.

    python3 benchmarks_torch/slip_int8_cosine.py

For SLIP-ViT-L/16 and ViT-B/16 (DebiasCLIP, random init from seed 0, full
width and depth) and 256 of the smoke's seeded 224 px images, prints the
per-row cosine (min, mean) against the float32 plain tower of: the bf16
kernels; the int8 kernels; the plain int8 route (``fused=False``: the
layers the JAX package runs on XLA, products through ``torch._int_mm``) at
bfloat16 and at float32 activations; the int8 kernels against that plain
route; and both int8 paths from the normalized float images (the dynamic
per-patch int8 stem) instead of the uint8 patch staging (the exact stem
with the normalize folded into int8 weights).  Prints the card's
nvidia-smi name and power limit.  Exits 2 without a card.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("facebookresearch/SLIP/ViT-L/16", "openai/CLIP/ViT-B/16")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("slip_int8_cosine: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops import _build
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.ops.quant import QuantizedCLIP
    from debias_vision_lang_torch.vision.preprocess import patchify_u8, preprocess_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_all(["fused_block", "fused_block_q"])
    fb.build()
    fbq.build()
    faces = C.SyntheticFaces(C.BATCH)
    u8 = np.stack([faces.load_image(i) for i in range(C.BATCH)])
    dev = torch.device("cuda")

    def cos(a, b):
        c = torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1)
        return f"min {c.min().item():.6f} mean {c.mean().item():.6f}"

    for arch in ARCHS:
        model, *_ = DebiasCLIP.from_cfg({"CLIP_ARCH": arch, "PRETRAINED": False, "SEED": 0},
                                        device=dev)
        vis = model.clip_cfg.vision
        p8 = torch.from_numpy(patchify_u8(u8, vis.patch_size)).to(dev)
        x = preprocess_batch(torch.from_numpy(u8).to(dev), vis.image_size,
                             mean=vis.image_mean, std=vis.image_std)
        q = QuantizedCLIP(model)
        with torch.no_grad():
            f32 = model.encode_image(p8, dtype=torch.float32).float()
            f32x = model.encode_image(x, dtype=torch.float32).float()
            k8 = q.encode_image(p8).float()
            plain8 = q.encode_image(p8, fused=False).float()
            rows = [
                ("bf16 kernels, uint8 staging", model.encode_image(p8).float(), f32),
                ("int8 kernels, uint8 staging", k8, f32),
                ("plain int8, bf16 activations, uint8 staging", plain8, f32),
                ("plain int8, float32 activations, uint8 staging",
                 q.encode_image(p8, dtype=torch.float32).float(), f32),
                ("int8 kernels vs plain int8 (bf16), uint8 staging", k8, plain8),
                ("int8 kernels, float images", q.encode_image(x).float(), f32x),
                ("plain int8, float32 activations, float images",
                 q.encode_image(x, dtype=torch.float32).float(), f32x)]
        print(f"{arch} (B={C.BATCH}, against the float32 plain tower unless named):")
        for name, got, ref in rows:
            print(f"  {name}: cosine {cos(got, ref)}")
        del model, q
        torch.cuda.empty_cache()
    print(C.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
