#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit, torch / CUDA versions, optional hosts
     packages (information only);
  2. build the hand-written kernels (csrc/fused_block.cu and
     csrc/fused_block_q.cu, one nvcc each, started together, sm_90a);
  3. kernel phase: each bf16 kernel against its plain PyTorch twin on the card,
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
  6. int8 kernel phase: attention_block_q and mlp_block_q against their twins
     (weights from ops/quant.quantize_weight) at the same shapes, plus an
     act_kind="gelu" MLP; the same 1-ulp bar on the output, and on the int8
     codes of the quantized rows (LN output, attention output, MLP hidden):
     the twin's quantizer applied to the kernel's own rows gives the kernel's
     codes and scales exactly, and the codes differ from the twin's in at
     most 1e-3 of all (by at most 1 in the LN and hidden rows);
  7. the int8 main path: the same model and images through
     get_labels_img_embeddings(dtype="int8") (QuantizedCLIP, P8 staging, the
     int8 kernels with bf16 activations between them): 12 x 4 launches of
     each int8 kernel and none of the bf16 ones, metrics equal to the numpy
     oracle, int8 image embeddings against the float32 plain path (cosine);
  8. the int8 text tower ("int8-text"): 12 causal int8 launches, cosine
     against the float32 text tower;
  9. timings: kernels vs twins, image-tower img/s with the bf16 kernels, the
     int8 kernels, the plain int8 path (torch._int_mm products), the plain
     bf16 path and the float32 path.
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
COS_MIN = 0.999  # per-row cosine, bf16 / int8 kernel path vs the float32 plain path
METRIC_ATOL = 1e-5  # device ranking engine vs the numpy oracle
CODE_SHARE_MAX = 1e-3  # int8 codes of a block's quantized rows that differ from the twin's
# a bf16 flip of a row's largest attention output (the attention core sums
# in another order than the twin) moves that row's scale, and with it the
# codes of the row by up to one more step than the element's own flip
CODE_DIFF_MAX = {"xq": 1, "hq": 1, "aq": 2}
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


def print_ptxas(lib: str, log: str) -> None:
    """One line per compiled kernel from nvcc's -Xptxas -v report."""
    name = spill = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?"
                      r"(gemm_q_kernel|gemm_kernel|attention_core_kernel|layer_norm_kernel|"
                      r"quant_rows_kernel)(?:I(13__nv_bfloat16|f)?Li(\d+)E)?", line)
        if m:
            args = [a for a in ({"13__nv_bfloat16": "bf16", "f": "f32"}.get(m.group(2)),
                                m.group(3)) if a]
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"ptxas {lib} {name}: {m.group(1)} registers, {spill} bytes spill stores")
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


def q_block_params(d, device, seed):
    """block_params with the four weights quantized by the port's
    quantize_weight: (positional args, the kernels' transposed copies)."""
    from debias_vision_lang_torch.ops.quant import QWeight

    (ls, lb, wqkv, bqkv, wo, bo), (l2s, l2b, w1, b1, w2, b2) = block_params(d, device, seed)
    wqkv, wo, w1, w2 = map(QWeight, (wqkv, wo, w1, w2))
    return (((ls, lb, wqkv.q, wqkv.scale, bqkv, wo.q, wo.scale, bo),
             {"wqkv_qt": wqkv.qt, "wo_qt": wo.qt}),
            ((l2s, l2b, w1.q, w1.scale, b1, w2.q, w2.scale, b2),
             {"w1_qt": w1.qt, "w2_qt": w2.qt}))


def kernel_phase_q(fbq, device):
    """attention_block_q / mlp_block_q against their twins at the B=8 shapes
    (x and x/16, and a gelu MLP), at the int8 main path's B=256 image shapes
    and at the int8 text tower's B=319 shapes (timed).  Returns the JSON rows
    without launch counts, and the text-shape times."""
    import torch

    def compare(name, kern, plain, x, block, kw):
        args, qkw = block
        sk, sr = {}, {}
        got = kern(x, *args, **kw, **qkw, scratch=sk)
        ref = plain(x, *args, **kw, scratch=sr)
        err = (got.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        own = (ref.float() - x.float()).abs().max().item()
        tol = ulp_bf16(mag)
        print(f"kernel {name}: max_abs_err {err} (tolerance {tol} = 1 bf16 ulp of "
              f"max |twin| {mag}; max |twin - x| {own})")
        check(math.isfinite(err) and err <= tol, f"{name}: kernel disagrees with its twin")
        n_codes = n_diff = 0
        for codes, rows, scales in (("xq", "xn", "xs"), ("aq", "attn", "as"), ("hq", "h", "hs")):
            if codes not in sk:
                continue
            q, s = fbq.quant_rows(sk[rows])
            check(torch.equal(q, sk[codes]) and torch.equal(s, sk[scales]),
                  f"{name}: the kernel's {codes} codes are not the quantization of "
                  f"its own {rows} rows")
            diff = (sk[codes].int() - sr[codes].int()).abs()
            worst, n = diff.max().item(), diff.ne(0).sum().item()
            print(f"  {codes} codes: the quantization of the kernel's own {rows} rows; "
                  f"{n / diff.numel():.3e} differ from the twin's, max |diff| {worst} "
                  f"(bar {CODE_DIFF_MAX[codes]})")
            check(worst <= CODE_DIFF_MAX[codes], f"{name}: {codes} codes off by {worst}")
            n_codes, n_diff = n_codes + diff.numel(), n_diff + n
        print(f"  all codes: {n_diff / n_codes:.3e} differ (bar {CODE_SHARE_MAX})")
        check(n_diff / n_codes <= CODE_SHARE_MAX, f"{name}: int8 codes drift from the twin's")
        return err

    attn_fns = (fbq.attention_block_q, fbq.attention_block_q_plain)
    mlp_fns = (fbq.mlp_block_q, fbq.mlp_block_q_plain)
    g = torch.Generator().manual_seed(2)
    for b, s, d, heads, causal in ((8, 197, 768, 12, False), (8, 77, 512, 8, True)):
        attn, mlp = q_block_params(d, device, seed=d)
        for scale in (1.0, 1 / 16):
            x = (torch.randn(b, s, d, generator=g) * scale).to(device, torch.bfloat16)
            tag = f"B={b} S={s} D={d} x~N(0,{scale}^2)"
            compare(f"attention_block_q {tag} H={heads} causal={causal}", *attn_fns, x, attn,
                    {"heads": heads, "causal": causal})
            compare(f"mlp_block_q {tag} F={4 * d} quick_gelu", *mlp_fns, x, mlp, {})
        if not causal:
            x = torch.randn(b, s, d, generator=g).to(device, torch.bfloat16)
            compare(f"mlp_block_q B={b} S={s} D={d} F={4 * d} gelu", *mlp_fns, x, mlp,
                    {"act_kind": "gelu"})
    torch.cuda.synchronize()

    attn, mlp = q_block_params(768, device, seed=7)
    x = torch.randn(BATCH, 197, 768, generator=g).to(device, torch.bfloat16)
    rows = []
    for name, (kern, plain), block, kw, line in (
            ("attention_block_q", attn_fns, attn, {"heads": 12}, 62),
            ("mlp_block_q", mlp_fns, mlp, {}, 106)):
        err = compare(f"{name} B={BATCH} S=197 D=768 (int8 main path)", kern, plain, x,
                      block, kw)
        ms = cuda_ms(lambda: kern(x, *block[0], **kw, **block[1]))
        plain_ms = cuda_ms(lambda: plain(x, *block[0], **kw))
        rows.append({"name": name, "route": "cuda",
                     "source": "debias_vision_lang_torch/csrc/fused_block_q.cu",
                     "replaces": f"debias_vision_lang_tpu/ops/fused_block_q.py:{line}",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms})
    # the int8 text tower's shapes (causal attention), timed too
    attn_t, mlp_t = q_block_params(512, device, seed=11)
    xt = torch.randn(319, 77, 512, generator=g).to(device, torch.bfloat16)
    compare("attention_block_q B=319 S=77 D=512 H=8 causal", *attn_fns, xt, attn_t,
            {"heads": 8, "causal": True})
    compare("mlp_block_q B=319 S=77 D=512 F=2048 quick_gelu", *mlp_fns, xt, mlp_t, {})
    ca = {"heads": 8, "causal": True}
    text_ms = {
        "attention_block_q causal": (
            cuda_ms(lambda: fbq.attention_block_q(xt, *attn_t[0], **ca, **attn_t[1])),
            cuda_ms(lambda: fbq.attention_block_q_plain(xt, *attn_t[0], **ca))),
        "mlp_block_q": (cuda_ms(lambda: fbq.mlp_block_q(xt, *mlp_t[0], **mlp_t[1])),
                        cuda_ms(lambda: fbq.mlp_block_q_plain(xt, *mlp_t[0]))),
    }
    return rows, text_ms


def check_metrics(tag, labels, img_embs, prompt_embs, eval_ranking):
    """Metrics at top-n 100% and 10% from the device engine: finite, equal to
    the numpy oracle, and MaxSkew of the top 10% > 0."""
    metrics = {f"{ev}@{topn}": eval_ranking(labels, img_embs, prompt_embs, ev, topn)
               for ev in ("maxskew", "ndkl") for topn in TOPNS}
    print(f"{tag} metrics: {json.dumps(metrics)}")
    check(all(math.isfinite(v) for m in metrics.values() for v in m.values()),
          f"{tag}: non-finite metrics")
    check(metrics[f"maxskew@{TOPNS[1]}"]["eq_opp"] > 0,
          f"{tag}: MaxSkew of the top 10% is 0: the ranking is degenerate")
    for key, m in metrics.items():
        ev, topn = key.split("@")
        ref = eval_ranking(labels, img_embs, prompt_embs, ev, float(topn),
                           engine="oracle")
        for k, v in m.items():
            check(abs(v - ref[k]) <= METRIC_ATOL,
                  f"{tag} {key}/{k}: device {v} vs oracle {ref[k]}")
    print(f"{tag} metrics agree with the numpy oracle within {METRIC_ATOL}")


def cosine_check(tag, got, ref):
    import torch

    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    print(f"{tag}: cosine min {cos.min().item():.6f} mean {cos.mean().item():.6f} "
          f"(bar: min >= {COS_MIN})")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite embeddings")
    check(cos.min().item() >= COS_MIN, f"{tag}: drift from float32")


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
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.ops.quant import resolve_compute
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

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    _build.load_all(["fused_block", "fused_block_q"])
    fb.build()
    fbq.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS or 'cached'})")
    for lib in ("fused_block", "fused_block_q"):
        print_ptxas(lib, _build.BUILD_LOG.get(lib, ""))

    # 3. bf16 kernels against their twins
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
    n_batches = N_IMAGES // BATCH
    torch.cuda.synchronize()
    fb.reset_launches()
    fbq.reset_launches()
    t0 = time.perf_counter()
    labels, img_embs = get_labels_img_embeddings(loader, model, n_px=vis.image_size,
                                                 dtype="bfloat16")
    prompt_embs = get_prompt_embeddings(model, tokenizer, prompts)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {**fb.LAUNCHES, **fbq.LAUNCHES}
    print(f"main path: {N_IMAGES} images + {len(prompts)} prompts in {main_s:.3f} s "
          f"(host clock, includes decode); launches {launches}")
    check(launches["attention_block"] == LAYERS * n_batches,
          f"attention_block launched {launches['attention_block']} times, "
          f"expected {LAYERS * n_batches}")
    check(launches["mlp_block"] == LAYERS * n_batches,
          f"mlp_block launched {launches['mlp_block']} times")
    check(img_embs.shape == (N_IMAGES, vis.embed_dim) and img_embs.is_cuda,
          f"image embeddings {tuple(img_embs.shape)}")
    check(prompt_embs.shape == (len(prompts), vis.embed_dim), "prompt embeddings")
    check_metrics("bf16", labels, img_embs, prompt_embs, eval_ranking)

    first = next(iter(loader)).images
    p8 = torch.from_numpy(first).to(device)
    with torch.no_grad():
        ref32 = model.encode_image(p8, dtype=torch.float32).float()
    cosine_check("bf16 kernel path vs float32 plain path, image embeddings",
                 img_embs[:BATCH], ref32)

    # 5. the bf16 text tower through the causal kernel
    tokens = torch.as_tensor(tokenizer(prompts), dtype=torch.long, device=device)
    fb.reset_launches()
    with torch.no_grad():
        txt16 = model.encode_text(tokens, dtype=torch.bfloat16).float()
        txt32 = model.encode_text(tokens).float()
    torch.cuda.synchronize()
    causal = fb.LAUNCHES["attention_block_causal"]
    print(f"bf16 text tower: causal attention_block launches {causal}, mlp_block "
          f"{fb.LAUNCHES['mlp_block']}")
    check(causal == LAYERS, "the bf16 text tower did not run the causal kernel")
    cosine_check("bf16 text tower vs float32", txt16, txt32)

    # 6. int8 kernels against their twins
    rows_q, text_ms_q = kernel_phase_q(fbq, device)

    # 7. the int8 main path: the same model and images, wrapped once
    t0 = time.perf_counter()
    qmodel, _ = resolve_compute(model, "int8")
    torch.cuda.synchronize()
    print(f"QuantizedCLIP built in {time.perf_counter() - t0:.2f} s")
    fb.reset_launches()
    fbq.reset_launches()
    t0 = time.perf_counter()
    labels_q, img_q = get_labels_img_embeddings(loader, qmodel, n_px=vis.image_size,
                                                dtype="int8")
    prompt_q = get_prompt_embeddings(qmodel, tokenizer, prompts)
    torch.cuda.synchronize()
    main_q_s = time.perf_counter() - t0
    launches_q = {**fb.LAUNCHES, **fbq.LAUNCHES}
    print(f"int8 main path: {N_IMAGES} images + {len(prompts)} prompts in {main_q_s:.3f} s "
          f"(host clock, includes decode); launches {launches_q}")
    for name in ("attention_block_q", "mlp_block_q"):
        check(launches_q[name] == LAYERS * n_batches,
              f"{name} launched {launches_q[name]} times, expected {LAYERS * n_batches}")
    check(sum(fb.LAUNCHES.values()) == 0, "the int8 path launched bf16 kernels")
    check(img_q.shape == (N_IMAGES, vis.embed_dim) and img_q.is_cuda,
          f"int8 image embeddings {tuple(img_q.shape)}")
    check(np.array_equal(labels_q, labels), "the int8 pass saw other labels")
    check_metrics("int8", labels_q, img_q, prompt_q, eval_ranking)
    cosine_check("int8 kernel path vs float32 plain path, image embeddings",
                 img_q[:BATCH], ref32)

    # 8. the int8 text tower ("int8-text") through the causal int8 kernel
    qtext, _ = resolve_compute(model, "int8-text")
    fbq.reset_launches()
    with torch.no_grad():
        txt8 = qtext.encode_text(tokens).float()
    torch.cuda.synchronize()
    causal_q = fbq.LAUNCHES["attention_block_q_causal"]
    print(f"int8 text tower: causal attention_block_q launches {causal_q}, mlp_block_q "
          f"{fbq.LAUNCHES['mlp_block_q']}")
    check(causal_q == LAYERS and fbq.LAUNCHES["mlp_block_q"] == LAYERS,
          "the int8 text tower did not run the causal int8 kernels")
    cosine_check("int8 text tower vs float32", txt8, txt32)

    # 9. timings
    for row, counts in [(r, launches) for r in rows] + [(r, launches_q) for r in rows_q]:
        row["launches"] = counts[row["name"]]
        print(f"time {row['name']} B={BATCH} S=197 D=768: kernel {row['ms']:.4f} ms, "
              f"plain twin {row['plain_ms']:.4f} ms ({card})")
    for name, (k_ms, p_ms) in {**text_ms, **text_ms_q}.items():
        print(f"time {name} B=319 S=77 D=512: kernel {k_ms:.4f} ms, plain twin "
              f"{p_ms:.4f} ms ({card})")
    with torch.no_grad():
        for label, tower, kw in (
                ("kernels (bf16)", model, {"dtype": torch.bfloat16}),
                ("kernels (int8)", qmodel, {}),
                ("plain int8 (torch._int_mm)", qmodel, {"fused": False}),
                ("plain bf16", model, {"dtype": torch.bfloat16, "fused": False}),
                ("plain float32", model, {"dtype": torch.float32})):
            ms = cuda_ms(lambda: tower.encode_image(p8, **kw), iters=5)
            print(f"image tower B={BATCH} {label}: {ms:.3f} ms/batch, "
                  f"{BATCH / ms * 1e3:.1f} img/s ({card})")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    print(json.dumps({"kernels": rows + rows_q}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
