#!/usr/bin/env python3
"""Why smoke phase 18 takes its ResNets' BatchNorm statistics on images and
feeds them structured scenes, not iid noise.

    python3 benchmarks_torch/resnet_image_spread.py [--device cpu] [--n 1024]

Builds phase 18's RN50 (random init from seed 0) twice, its BatchNorms
redrawn by ``chip_smoke.redraw_batch_norms`` with drawn running statistics
and with statistics taken on 32 seeded scenes (phase 18's tower), embeds
``--n`` images of each kind (``chip_smoke.SyntheticFaces``: iid uniform
noise; ``SyntheticScenes``: a bilinear 4 x 4 colour grid plus noise) at
float32, and prints for each tower and kind:
the pairwise cosine of the image embeddings (min and mean over the first
64), the device ranking engine's largest distance to the numpy oracle over
MaxSkew and NDKL at top-n 100% and 10% (319 prompts, byte tokenizer), and
the largest move of those metrics when every embedding is scaled by
(1 + 2e-7 N(0, 1)), a perturbation at float32 rounding.  A ranking whose
metrics move under it reads rounding, not the tower.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1024)
    args = ap.parse_args()
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from debias_vision_lang_torch.eval.measure import eval_ranking, gen_prompts
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.text import ByteTokenizer

    device = torch.device(args.device)
    model, _, _, _ = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/RN50", "NUM_DEBIAS_TOKENS": 2, "PRETRAINED": False,
         "SEED": 0}, device=device)
    vis = model.clip_cfg.vision
    tok = ByteTokenizer()
    with torch.no_grad():
        txt = model.encode_text(torch.as_tensor(tok(gen_prompts()), device=device)).float()
    txt = txt / txt.norm(dim=-1, keepdim=True)
    labels = np.arange(args.n) % 2
    where = C.smi() if device.type == "cuda" else "CPU"
    calib = C.scene_batch(C.SyntheticScenes(32, seed=C.CALIB_SEED, px=vis.image_size), vis,
                          device)
    for stats, kind in ((s, k) for s in ("drawn", "calibrated")
                        for k in (C.SyntheticFaces, C.SyntheticScenes)):
        C.redraw_batch_norms(model.clip.visual, seed=18,
                             calibrate=calib if stats == "calibrated" else None)
        data = kind(args.n, px=vis.image_size)
        with torch.no_grad():
            e = torch.cat([model.encode_image(C.scene_batch(data, vis, device, b,
                                                            min(b + 64, args.n))).float()
                           for b in range(0, args.n, 64)])
        en = e[:64] / e[:64].norm(dim=-1, keepdim=True)
        cos = (en @ en.T)[~torch.eye(len(en), dtype=torch.bool, device=device)]
        engine = moved = 0.0
        for ev in ("maxskew", "ndkl"):
            for topn in (1.0, 0.1):
                ref = eval_ranking(labels, e, txt, ev, topn, engine="oracle")
                got = eval_ranking(labels, e, txt, ev, topn)
                noise = torch.randn(e.shape, generator=torch.Generator().manual_seed(0))
                per = eval_ranking(labels, e * (1 + 2e-7 * noise.to(device)), txt, ev, topn)
                engine = max([engine] + [abs(got[k] - ref[k]) for k in ref])
                moved = max([moved] + [abs(per[k] - got[k]) for k in ref])
        print(f"BatchNorm statistics {stats}, {kind.__name__}: pairwise cosine min "
              f"{cos.min().item():.7f} mean {cos.mean().item():.7f}; engine vs oracle max "
              f"{engine:.3e}; metrics moved by a 2e-7 perturbation: max {moved:.3e} "
              f"(N={args.n}, {where})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
