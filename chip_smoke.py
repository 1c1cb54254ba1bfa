#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit, torch / CUDA versions, optional hosts
     packages (information only);
  2. build the hand-written kernels (csrc/fused_block.cu, nvcc, sm_90a);
  3. kernel phase: each kernel against its plain PyTorch twin on the card,
     bf16, at B=8 for the image (S=197 D=768 H=12) and text (S=77 D=512 H=8,
     causal) shapes, at the main path's B=256 image shapes and at the bf16
     text tower's B=319 shapes; tolerance: max |kernel - twin| <= one bf16
     ulp of the twin's largest magnitude.  At B=8 each block also runs on a
     residual stream scaled by 1/16, where the output is mostly the block's
     own contribution, so the bar is tight against the attention / MLP math
     and not only against the residual;
  4. main path: a ViT-B/16 DebiasCLIP (2 prepended prompt tokens, random
     init from seed 0, full width and depth) through HostLoader (batch 256,
     patch-contiguous staging), get_labels_img_embeddings(dtype="bfloat16"),
     get_prompt_embeddings (the 319 generated prompts, stdlib byte
     tokenizer) and eval_ranking, on 1,024 seeded 224x224 uint8 images with
     balanced binary labels; the launch counters must show 12 x 4 launches
     of each kernel; metrics (whole ranking, and the top 10%, where MaxSkew
     is not trivially 0) finite and equal to the numpy oracle; bf16 image
     embeddings against the float32 plain path (cosine);
  5. the bf16 text tower once (causal attention kernel), cosine against the
     float32 text tower;
  6. timings: kernels vs twins, image-tower img/s with the kernels, the
     plain bf16 path and the float32 path.
The line before the last is the card's ``nvidia-smi`` name and power limit;
the last line is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

BATCH, N_IMAGES, LAYERS = 256, 1024, 12
COS_MIN = 0.999  # per-row cosine, bf16 kernel path vs the float32 plain path
METRIC_ATOL = 1e-5  # device ranking engine vs the numpy oracle
TOPNS = (1.0, 0.1)  # whole ranking (measure_bias's default) and the top 10%


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def ulp_bf16(mag: float) -> float:
    return 2.0 ** (math.floor(math.log2(mag)) - 7)


def cuda_ms(fn, iters=10):
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


class SyntheticFaces:
    """In-memory dataset: seeded 224x224x3 uint8 images, balanced labels."""

    def __init__(self, n: int, seed: int = 0):
        self.n, self.seed = n, seed
        self.iat_labels = np.arange(n) % 2

    def __len__(self):
        return self.n

    def load_image(self, i: int) -> np.ndarray:
        return np.random.default_rng(self.seed + i).integers(
            0, 256, (224, 224, 3), dtype=np.uint8)


def print_ptxas(log: str) -> None:
    """One line per compiled kernel from nvcc's -Xptxas -v report."""
    name = spill = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?"
                      r"(gemm_kernel|attention_core_kernel|layer_norm_kernel)(?:ILi(\d+)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"ptxas {name}: {m.group(1)} registers, {spill} bytes spill stores")
            name = None


def block_params(d, device, seed):
    import torch

    g = torch.Generator().manual_seed(seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(device)

    # unit-gain projections (as tests/test_torch_fused_block.py draws them),
    # so the block's contribution is O(1) beside a unit residual
    f = 4 * d
    attn = (1 + 0.1 * rn(d), 0.1 * rn(d), rn(d, 3 * d, std=d ** -0.5),
            0.1 * rn(3 * d), rn(d, d, std=d ** -0.5), 0.1 * rn(d))
    mlp = (1 + 0.1 * rn(d), 0.1 * rn(d), rn(d, f, std=(2 * d) ** -0.5), 0.1 * rn(f),
           rn(f, d, std=f ** -0.5), 0.1 * rn(d))
    return attn, mlp


def kernel_phase(fb, device):
    """Kernel vs twin at the B=8 shapes, at the main path's B=256 image
    shapes and at the text tower's B=319 shapes (timed).  Returns the JSON
    rows without launch counts, and the text-shape times."""
    import torch

    def compare(name, x, got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        own = (ref.float() - x.float()).abs().max().item()
        tol = ulp_bf16(mag)
        print(f"kernel {name}: max_abs_err {err} (tolerance {tol} = 1 bf16 ulp of "
              f"max |twin| {mag}; max |twin - x| {own})")
        check(math.isfinite(err) and err <= tol, f"{name}: kernel disagrees with its twin")
        return err

    g = torch.Generator().manual_seed(1)
    for b, s, d, heads, causal in ((8, 197, 768, 12, False), (8, 77, 512, 8, True)):
        attn, mlp = block_params(d, device, seed=d)
        for scale in (1.0, 1 / 16):
            x = (torch.randn(b, s, d, generator=g) * scale).to(device, torch.bfloat16)
            tag = f"B={b} S={s} D={d} x~N(0,{scale}^2)"
            compare(f"attention_block {tag} H={heads} causal={causal}", x,
                    fb.attention_block(x, *attn, heads=heads, causal=causal),
                    fb.attention_block_plain(x, *attn, heads=heads, causal=causal))
            compare(f"mlp_block {tag} F={4 * d} quick_gelu", x,
                    fb.mlp_block(x, *mlp), fb.mlp_block_plain(x, *mlp))
    torch.cuda.synchronize()

    attn, mlp = block_params(768, device, seed=7)
    x = torch.randn(BATCH, 197, 768, generator=g).to(device, torch.bfloat16)
    rows = []
    for name, kern, plain, args, kw, line in (
            ("attention_block", fb.attention_block, fb.attention_block_plain, attn,
             {"heads": 12}, 69),
            ("mlp_block", fb.mlp_block, fb.mlp_block_plain, mlp, {}, 192)):
        err = compare(f"{name} B={BATCH} S=197 D=768 (main path)", x,
                      kern(x, *args, **kw), plain(x, *args, **kw))
        ms = cuda_ms(lambda: kern(x, *args, **kw))
        plain_ms = cuda_ms(lambda: plain(x, *args, **kw))
        rows.append({"name": name, "route": "cuda",
                     "source": "debias_vision_lang_torch/csrc/fused_block.cu",
                     "replaces": f"debias_vision_lang_tpu/ops/fused_block.py:{line}",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms})
    # the bf16 text tower's shapes (causal attention), timed too
    attn_t, mlp_t = block_params(512, device, seed=11)
    xt = torch.randn(319, 77, 512, generator=g).to(device, torch.bfloat16)
    compare("attention_block B=319 S=77 D=512 H=8 causal", xt,
            fb.attention_block(xt, *attn_t, heads=8, causal=True),
            fb.attention_block_plain(xt, *attn_t, heads=8, causal=True))
    compare("mlp_block B=319 S=77 D=512 F=2048 quick_gelu", xt,
            fb.mlp_block(xt, *mlp_t), fb.mlp_block_plain(xt, *mlp_t))
    text_ms = {
        "attention_block causal": (
            cuda_ms(lambda: fb.attention_block(xt, *attn_t, heads=8, causal=True)),
            cuda_ms(lambda: fb.attention_block_plain(xt, *attn_t, heads=8, causal=True))),
        "mlp_block": (cuda_ms(lambda: fb.mlp_block(xt, *mlp_t)),
                      cuda_ms(lambda: fb.mlp_block_plain(xt, *mlp_t))),
    }
    return rows, text_ms


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU port only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from debias_vision_lang_torch.eval.measure import (eval_ranking, gen_prompts,
                                                      get_labels_img_embeddings,
                                                      get_prompt_embeddings)
    from debias_vision_lang_torch.data.loader import HostLoader
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops import _build
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.text import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = smi()

    # 1. information
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    import importlib.util

    for mod in ("pandas", "regex", "PIL", "jax"):
        print(f"optional package {mod}: "
              f"{'present' if importlib.util.find_spec(mod) else 'absent'}")

    # 2. build
    t0 = time.perf_counter()
    fb.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS or 'cached'})")
    print_ptxas(_build.BUILD_LOG.get("fused_block", ""))

    # 3. kernels against their twins
    rows, text_ms = kernel_phase(fb, device)

    # 4. main path
    t0 = time.perf_counter()
    model, _, tokenizer, alias = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False,
         "NUM_DEBIAS_TOKENS": 2, "DEBIAS_POS": "prepend", "SEED": 0}, device=device)
    model.eval()
    tokenizer = tokenizer or ByteTokenizer()
    vis = model.clip_cfg.vision
    print(f"model {alias}: {sum(p.numel() for p in model.parameters())} params, "
          f"built in {time.perf_counter() - t0:.2f} s, tokenizer "
          f"{type(tokenizer).__name__}")
    loader = HostLoader(SyntheticFaces(N_IMAGES), batch_size=BATCH, num_workers=8,
                        native_n_px=vis.image_size, native_patch=vis.patch_size)
    prompts = gen_prompts()
    torch.cuda.synchronize()
    fb.reset_launches()
    t0 = time.perf_counter()
    labels, img_embs = get_labels_img_embeddings(loader, model, n_px=vis.image_size,
                                                 dtype="bfloat16")
    prompt_embs = get_prompt_embeddings(model, tokenizer, prompts)
    metrics = {f"{ev}@{topn}": eval_ranking(labels, img_embs, prompt_embs, ev, topn)
               for ev in ("maxskew", "ndkl") for topn in TOPNS}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    print(f"main path: {N_IMAGES} images + {len(prompts)} prompts in {main_s:.3f} s "
          f"(host clock, includes decode); launches {launches}")
    print(f"metrics: {json.dumps(metrics)}")
    n_batches = N_IMAGES // BATCH
    check(launches["attention_block"] == LAYERS * n_batches,
          f"attention_block launched {launches['attention_block']} times, "
          f"expected {LAYERS * n_batches}")
    check(launches["mlp_block"] == LAYERS * n_batches,
          f"mlp_block launched {launches['mlp_block']} times")
    check(img_embs.shape == (N_IMAGES, vis.embed_dim) and img_embs.is_cuda,
          f"image embeddings {tuple(img_embs.shape)}")
    check(prompt_embs.shape == (len(prompts), vis.embed_dim), "prompt embeddings")
    check(bool(torch.isfinite(img_embs).all()), "non-finite image embeddings")
    check(all(math.isfinite(v) for m in metrics.values() for v in m.values()),
          "non-finite metrics")
    check(metrics[f"maxskew@{TOPNS[1]}"]["eq_opp"] > 0,
          "MaxSkew of the top 10% is 0: the ranking is degenerate")
    for key, m in metrics.items():
        ev, topn = key.split("@")
        ref = eval_ranking(labels, img_embs, prompt_embs, ev, float(topn),
                           engine="oracle")
        for k, v in m.items():
            check(abs(v - ref[k]) <= METRIC_ATOL, f"{key}/{k}: device {v} vs oracle {ref[k]}")
    print(f"metrics agree with the numpy oracle within {METRIC_ATOL}")

    first = next(iter(loader)).images
    p8 = torch.from_numpy(first).to(device)
    with torch.no_grad():
        ref32 = model.encode_image(p8, dtype=torch.float32).float()
    cos = torch.nn.functional.cosine_similarity(img_embs[:BATCH], ref32, dim=-1)
    print(f"bf16 kernel path vs float32 plain path, image embeddings: cosine min "
          f"{cos.min().item():.6f} mean {cos.mean().item():.6f} (bar: min >= {COS_MIN})")
    check(cos.min().item() >= COS_MIN, "bf16 image embeddings drift from float32")

    # 5. the bf16 text tower through the causal kernel
    tokens = torch.as_tensor(tokenizer(prompts), dtype=torch.long, device=device)
    fb.reset_launches()
    with torch.no_grad():
        txt16 = model.encode_text(tokens, dtype=torch.bfloat16).float()
        txt32 = model.encode_text(tokens).float()
    torch.cuda.synchronize()
    causal = fb.LAUNCHES["attention_block_causal"]
    tcos = torch.nn.functional.cosine_similarity(txt16, txt32, dim=-1)
    print(f"bf16 text tower: causal attention_block launches {causal}, mlp_block "
          f"{fb.LAUNCHES['mlp_block']}; cosine vs float32 min {tcos.min().item():.6f} "
          f"mean {tcos.mean().item():.6f} (bar: min >= {COS_MIN})")
    check(causal == LAYERS, "the bf16 text tower did not run the causal kernel")
    check(tcos.min().item() >= COS_MIN, "bf16 text embeddings drift from float32")
    check(bool(torch.isfinite(txt16).all()), "non-finite bf16 text embeddings")

    # 6. timings
    for row in rows:
        row["launches"] = launches[row["name"]]
        print(f"time {row['name']} B={BATCH} S=197 D=768: kernel {row['ms']:.4f} ms, "
              f"plain twin {row['plain_ms']:.4f} ms ({card})")
    for name, (k_ms, p_ms) in text_ms.items():
        print(f"time {name} B=319 S=77 D=512: kernel {k_ms:.4f} ms, plain twin "
              f"{p_ms:.4f} ms ({card})")
    with torch.no_grad():
        for label, kw in (("kernels (bf16)", {"dtype": torch.bfloat16}),
                          ("plain bf16", {"dtype": torch.bfloat16, "fused": False}),
                          ("plain float32", {"dtype": torch.float32})):
            ms = cuda_ms(lambda: model.encode_image(p8, **kw), iters=5)
            print(f"image tower B={BATCH} {label}: {ms:.3f} ms/batch, "
                  f"{BATCH / ms * 1e3:.1f} img/s ({card})")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
