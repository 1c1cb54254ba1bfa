#!/usr/bin/env python3
"""The port's headline benchmark: CLIP ViT-B/16 image-embedding throughput
on one card.

The counterpart of the root ``bench.py`` (the JAX package's bench): the
measurement's hot loop -- a batch of uint8 images through the image tower,
the device preprocess or the patch-contiguous stem included -- as images
per second.

    python -m debias_vision_lang_torch bench
    python3 benchmarks_torch/bench.py [--device cpu]

Prints ONE JSON line on stdout, anything else on stderr:
  {"metric": "clip_vit_b16_embed_throughput", "value": N,
   "unit": "images/sec/chip", "vs_baseline": N}

``vs_baseline`` divides by an A100 PyTorch fp16 estimate of the same loop
(1,000 img/s, DataLoader + encode_image at batch 256).  That denominator
models ViT-B/16 only: another arch's throughput divided by it is no A100
multiple.

Env knobs (the root ``bench.py``'s, with its defaults):
  BENCH_BATCH (512), BENCH_STEPS (20),
  BENCH_DTYPE (bfloat16 | float32; float32 turns BENCH_QUANT off),
  BENCH_QUANT (1 | 0, default 1: the int8 fused blocks, K3 + K4),
  BENCH_STEM (p8 | f32; default p8 with BENCH_QUANT, else f32): p8 feeds
    the patch-contiguous uint8 staging [B, P, patch^2 * 3] (the normalize
    folded into the stem; int8 or bfloat16 only), f32 the [B, 224, 224, 3]
    uint8 canvas through ``preprocess_batch``,
  BENCH_PALLAS (0 | 1, default 0): the plain layers with K5, the
    attention kernel, in place of the fused blocks; only on the card,
  BENCH_TIMEOUT_S (1800): after this many seconds the watchdog prints the
    record with value 0.0 and an ``error`` and exits 2.

The configurations and the kernels each call runs on ViT-B/16 (12 layers):
int8 with the P8 stem (the default) or the f32 stem: 12 K3 + 12 K4;
bfloat16 (BENCH_QUANT=0) with either stem: 12 K1 + 12 K2; bfloat16 with
BENCH_PALLAS=1: 12 K5 on its short route; float32: no kernel, or 12 K5
(3xTF32) with BENCH_PALLAS=1.

The weights are ViT-B/16 at full width from ``init_clip_params`` at seed 0;
the inputs are two alternating uint8 buffers from
``np.random.default_rng(0)``, put on the device once.  Two warm-up calls
(the kernels build in the first), then BENCH_STEPS timed calls on the host
clock between two ``torch.cuda.synchronize()``.  Without a card the bench
prints the error record and exits 2; ``--device cpu`` runs it on the CPU.
"""

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Callable, Mapping, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "openai/CLIP/ViT-B/16"
METRIC = "clip_vit_b16_embed_throughput"
UNIT = "images/sec/chip"
A100_TORCH_BASELINE_IMG_S = 1000.0


def record(ips: float, error: Optional[str] = None) -> dict:
    """The one JSON line: throughput and its ratio to the A100 estimate, or
    zeros and the error."""
    out = {"metric": METRIC, "value": round(ips, 1), "unit": UNIT,
           "vs_baseline": round(ips / A100_TORCH_BASELINE_IMG_S, 3)}
    if error is not None:
        out["error"] = error
    return out


def _watchdog(seconds: float) -> threading.Timer:
    """Keep the one-line contract when the run stalls (a hung card, a kernel
    build that does not end): after ``seconds`` print the error record and
    exit 2."""
    def fire():
        print(json.dumps(record(0.0, f"bench timed out after {seconds:.0f}s "
                                     "(the device or the kernel build stalled)")),
              flush=True)
        os._exit(2)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


@dataclasses.dataclass(frozen=True)
class Knobs:
    batch: int
    steps: int
    dtype: str  # "bfloat16" or "float32"
    quant: bool
    use_p8: bool
    use_pallas: bool
    timeout_s: float


def parse_knobs(env: Mapping[str, str], on_card: bool) -> Knobs:
    """The root bench.py's knobs from an env mapping: BENCH_DTYPE=float32
    turns the int8 rung off, the stem defaults to p8 only under it, the P8
    stem needs int8 or bfloat16, and BENCH_PALLAS counts only ``on_card``."""
    dtype = "bfloat16" if env.get("BENCH_DTYPE", "bfloat16") == "bfloat16" else "float32"
    quant = bool(int(env.get("BENCH_QUANT", "1")))
    if env.get("BENCH_DTYPE") == "float32":
        quant = False
    stem = env.get("BENCH_STEM", "p8" if quant else "f32")
    return Knobs(batch=int(env.get("BENCH_BATCH", 512)),
                 steps=int(env.get("BENCH_STEPS", 20)),
                 dtype=dtype, quant=quant,
                 use_p8=stem == "p8" and (quant or dtype == "bfloat16"),
                 use_pallas=bool(int(env.get("BENCH_PALLAS", "0"))) and on_card,
                 timeout_s=float(env.get("BENCH_TIMEOUT_S", "1800")))


def build_model(cfg, device):
    """``CLIP(cfg)`` with ``init_clip_params``'s weights at seed 0, on
    ``device``, for inference."""
    import torch

    from debias_vision_lang_torch.models.clip import CLIP, init_clip_params

    model = CLIP(cfg)
    model.load_state_dict(init_clip_params(cfg, torch.Generator().manual_seed(0)))
    return model.requires_grad_(False).eval().to(device)


def make_embed(model, cfg, knobs: Knobs, device) -> Tuple[Callable, tuple]:
    """The embed call the knobs pick, uint8 images -> float32 [B, embed_dim],
    and the shape of its uint8 input: [B, P, patch^2 * 3] under the P8 stem,
    else [B, 224, 224, 3]."""
    import torch

    from debias_vision_lang_torch.models.clip import encode_image_vit_p8
    from debias_vision_lang_torch.ops.quant import (QuantVisual, encode_image_vit_q,
                                                    encode_image_vit_q_p8)
    from debias_vision_lang_torch.vision.preprocess import preprocess_batch

    vis = cfg.vision
    dtype = torch.bfloat16 if knobs.dtype == "bfloat16" else torch.float32
    model = model.to(device)
    if knobs.quant:
        vq = QuantVisual(model.visual)
        if knobs.use_p8:
            def tower(u8):
                return encode_image_vit_q_p8(vq, u8, dtype=dtype)
        else:
            def tower(u8):
                return encode_image_vit_q(vq, preprocess_batch(u8, vis.image_size),
                                          dtype=dtype)
    elif knobs.use_p8:
        def tower(u8):
            return encode_image_vit_p8(model.visual, u8, dtype=dtype,
                                       use_pallas=knobs.use_pallas)
    else:
        def tower(u8):
            return model.encode_image(preprocess_batch(u8, vis.image_size), dtype=dtype,
                                      use_pallas=knobs.use_pallas)

    def embed(u8):
        with torch.no_grad():
            return tower(u8).float()

    if knobs.use_p8:
        g = vis.image_size // vis.patch_size
        shape = (knobs.batch, g * g, vis.patch_size * vis.patch_size * 3)
    else:
        shape = (knobs.batch, 224, 224, 3)
    return embed, shape


def inputs(shape, device, seed: int = 0):
    """Two uint8 buffers from ``np.random.default_rng(seed)``, on ``device``."""
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(device)
            for _ in range(2)]


def run(embed: Callable, shape, knobs: Knobs, device) -> dict:
    """Two warm-up calls, then ``knobs.steps`` timed calls alternating the
    two buffers, fenced by ``torch.cuda.synchronize()`` on a card; returns
    the record."""
    import torch

    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    imgs = inputs(shape, device)
    t0 = time.perf_counter()
    embed(imgs[0])
    embed(imgs[1])
    sync()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(knobs.steps):
        embed(imgs[i % 2])
    sync()
    dt = time.perf_counter() - t0
    ips = knobs.batch * knobs.steps / dt
    print(f"bench: {knobs}, input {tuple(shape)} uint8 on {device}: warm-up "
          f"{warm_s:.3f} s, {knobs.steps} steps in {dt:.4f} s, {ips:.1f} img/s",
          file=sys.stderr)
    return record(ips)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="CLIP ViT-B/16 image-embedding "
                                                 "throughput; knobs in BENCH_* variables")
    parser.add_argument("--device", default="cuda",
                        help="torch device: the card (default) or 'cpu'")
    args = parser.parse_args(argv)
    on_card = not args.device.startswith("cpu")
    knobs = parse_knobs(os.environ, on_card)
    watchdog = _watchdog(knobs.timeout_s)
    try:
        import torch

        if on_card and not torch.cuda.is_available():
            print(json.dumps(record(0.0, f"no CUDA device for --device {args.device}: the "
                                         "bench measures the card (--device cpu runs it "
                                         "on the CPU)")), flush=True)
            return 2
        if ROOT not in sys.path:
            sys.path.insert(0, ROOT)
        from debias_vision_lang_torch.core.registry import resolve_arch

        device = torch.device(args.device)
        cfg = resolve_arch(ARCH)
        embed, shape = make_embed(build_model(cfg, device), cfg, knobs, device)
        rec = run(embed, shape, knobs, device)
    finally:
        watchdog.cancel()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
