#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit, torch / CUDA versions, optional hosts
     packages (information only);
  2. build the hand-written kernels (csrc/fused_block.cu,
     csrc/fused_block_q.cu and csrc/attention.cu, one nvcc each, started
     together, sm_90a); count instructions in each library's SASS
     (cuobjdump) and fail if a design's own is 0, so a build that fell back
     to mma.sync or to the CUDA cores cannot pass unseen: HGMMA (bf16 wgmma)
     and UTMALDG (TMA load) in the bf16 library, IGMMA (s8 wgmma), UTMALDG
     and HGMMA (K3's wgmma core) in the int8 library, HGMMA (K5's bf16 short
     route) and the TF32 HMMA forms (its 3xTF32 float32 short route) in the
     attention library; the int8 library must hold no mma.sync (HMMA.,
     IMMA.) at all; and per kernel, each of the six instantiations of K5's
     long route (attention_long_kernel at bf16 and f32, head dims 64, 128,
     192) must hold its own forms, bf16 wgmma (HGMMA ... BF16) or tf32 wgmma
     (HGMMA ... TF32) and TMA loads (UTMALDG), and no mma.sync (HMMA.);
  3. kernel phase: each bf16 kernel against its plain PyTorch twin on the card,
     bf16, at B=8 for the image (S=197 D=768 H=12) and text (S=77 D=512 H=8,
     causal) shapes, at every key bucket of the wgmma attention core (S = 1,
     7, 257, 320, causal and not, B=2 D=512 H=8), at a ragged M (B=3 S=77:
     231 rows, not a multiple of the GEMM's 128-row tile) for both blocks and
     both activations, at the main path's B=256 image shapes and at the bf16
     text tower's B=319 shapes; tolerance: max |kernel - twin| <= one bf16
     ulp of the twin's largest magnitude.  At B=8 and at the ragged M each
     block also runs on a residual stream scaled by 1/16, where the output is
     mostly the block's own contribution, so the bar is tight against the
     attention / MLP math and not only against the residual.  At B=256 the
     two blocks are split by sub-kernel with torch.profiler (LN, QKV GEMM,
     core, out GEMM; LN, up GEMM, down GEMM), each GEMM with its TFLOP/s and
     share of the bf16 peak;
  4. main path: first native.available() for the port's native ingest and,
     when it is false, its build error; the run fails unless the only cause
     is a machine without the codec headers (jpeglib.h, png.h), and every
     wall time that reads image files names the decode path it took, so none
     silently comes from the Python path; then a ViT-B/16 DebiasCLIP (2
     prepended prompt tokens, random
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
     most 1e-3 of all (by at most 1 in the LN and hidden rows, 2 in the
     attention rows); attention_block_q at every key bucket of the wgmma
     core (S = 1, 7, 200, 201, 256, 257, 320, causal and not, B=2 D=512
     H=8); a ragged M (B=3 S=77: 231 rows, x and x/16) for both blocks,
     causal and not, both activations; at B=256 both blocks are split by
     sub-kernel with torch.profiler (LN, quantize x and attn, QKV GEMM,
     core, out GEMM; LN, quantize x, up GEMM, quantize h, down GEMM), each
     GEMM with its TOP/s and share of the int8 peak;
  7. the int8 main path: the same model and images through
     get_labels_img_embeddings(dtype="int8") (QuantizedCLIP, P8 staging, the
     int8 kernels with bf16 activations between them): 12 x 4 launches of
     each int8 kernel and none of the bf16 ones, metrics equal to the numpy
     oracle, int8 image embeddings against the float32 plain path (cosine);
  8. the int8 text tower ("int8-text"): 12 causal int8 launches, cosine
     against the float32 text tower;
  9. K5 phase: attention_pallas (csrc/attention.cu) against its twin
     attention_kernel_math, TF32 off, float32 (3xTF32 on the tensor cores)
     and bfloat16 (the wgmma core on the short route; the two-pass wgmma +
     TMA kernel on the long one), at the image shapes B=8 and B=64 (H=12,
     S=197) with a zero and a random additive mask, the text shapes B=319
     (the sensitive prompts) and B=64 (a caption batch), H=8, S=77, with
     CLIP's causal mask, and the long route at B=8 H=12 S=785 (the
     Frozen-in-Time joint tower's token count) with a zero and a random
     mask and at B=32 (its measurement batch) with a zero mask, all timed
     beside F.scaled_dot_product_attention with the same additive mask at
     the same shapes and dtype (the yardstick; the port never calls it);
     then, checked only, B=2 H=8 at S = 1, 7, 32, 33, 80, 81, 200, 201, 256,
     257 and 320 (both sides of every key bucket) with the zero and the
     causal mask, a ragged B*H (B=3 H=5, S=197 and S=785, random mask), the
     long route at S = 321, 383, 384, 385, 400, 785, 1025 and 2048 (a ragged
     last key tile, both sides of the 128-query block, 16 and 32 key tiles)
     with the zero, random and causal masks and at head dims 32, 80, 128 and
     192 (S = 77 and 197; 192 also at S = 785), and at bfloat16 with every
     score shifted by 1e6; each call launches once, on
     the route ``_plan`` gives its shape; bars 2e-5 of the twin's largest
     magnitude at float32, one bf16 ulp at bfloat16; then the long route on
     a Frozen-in-Time joint tower's path: 12 layers of the public
     attention(use_pallas=True) at B=8 H=12 S=785, float32 forward and
     backward and bfloat16 forward, with the counters set to 0 before each
     run: 12 long-route launches and no short one, finite values;
 10. training on the K5 path: a copy of the phase-4 model in
     AdversarialTrainer.create(use_pallas=True), float32, batch 64, the 319
     prompts as the sensitive set, 64 caption tokens; 3 steps; the K5 launch
     count must be 60 per step (two image passes of 12 layers, the 319-prompt
     text tower for the adversary's scores and again with the 64 captions in
     the prompt step, 12 layers each; the backward recomputes through the
     twin and launches nothing), no K1-K4 launch, finite losses, moved
     tokens; the same three steps with use_pallas=False (no kernel), whose
     first token gradient and update must each have a cosine of at least
     0.9999 with the K5 path's;
 11. training on the bf16 fused path (train_dtype and embed_dtype
     "bfloat16"): per step K1 non-causal and K2 24 times in the two embed
     passes, causal K1 36 times in the text passes (K2 36 more); the token
     gradient of the bf16 text tower reaches the prompt array (cosine with
     the float32 gradient >= 0.99), and so does the first prompt step's
     (cosine >= 0.99 with the float32 step's); the first update, Adam's
     ~lr x sign(g), flips the sign of at most 5% of the elements of the
     float32 step's update (its cosine is reported);
 12. run_training at full width on a seeded synthetic FairFace layout in a
     temporary directory (256 train and 128 val images at 224 px, batch 64,
     one epoch of 4 steps, one eval at step 4 and the final one),
     use_pallas=True, once through the frozen-embedding cache and once
     decoding every batch: K5 launch counts as the two paths imply, the
     checkpoint and the .pt export (a bare float32 tensor) written, and the
     two runs end with identical losses and tokens;
 13. timings: kernels vs twins and their bounds, image-tower img/s with the
     bf16 kernels, the int8 kernels, the plain int8 path (torch._int_mm
     products), the plain bf16 path and the float32 path, and ms per
     training step on the float32 plain, K5 and bf16-kernel paths.
The kernels line gives each kernel's launches, error, time, plain-twin time,
its bound (the larger of its operations over the H100 SXM's dense peak for
their type and its bytes, each input read once and each output written once,
over 3.35 TB/s; K5's float32 operations count three TF32 products each, as
its 3xTF32 design runs them) and the library call's time where one PyTorch
call computes the same function.  K5 has two rows on its short route:
float32 causal B=319 S=77 (the text shape) and float32 B=64 S=197 (the image
shape that holds most of its training launches); its long route two more,
float32 and bfloat16 at B=8 H=12 S=785 with a zero mask, whose launches are
those of the joint tower's path in phase 9.  The line
before the last is the card's ``nvidia-smi``
name and power limit; the last line is {"ok": true, "device": {...}}.
"""

import copy
import csv
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
TRAIN_BATCH, TRAIN_STEPS = 64, 3
UPDATE_COS_K5 = 0.9999  # first token gradient and update, K5 vs the plain float32 path
UPDATE_COS_BF16 = 0.99  # token gradients, bf16 vs float32
UPDATE_FLIP_MAX_BF16 = 0.05  # first token update, bf16 vs float32: share of sign flips
# NVIDIA H100 SXM, dense: tensor-core bf16, int8 and TF32, float32 outside the
# tensor cores, and HBM3 bandwidth (the bounds in the kernels line)
PEAK = {"bf16": 989e12, "int8": 1979e12, "tf32": 494.7e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def bound(ops: dict, nbytes: float):
    """(ms, what bounds it): the larger of the operations over the peak for
    their type and the bytes over the memory rate."""
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_block_work(b, s, d, causal=False, weights="bf16"):
    """Operations by type and bytes of one attention block: the QKV and out
    projections in the weights' type, the core (Q K^T and P V over the key
    pairs the mask keeps) in bf16; x and out bf16, each read / written once."""
    m = b * s
    pairs = s * (s + 1) / 2 if causal else s * s
    wb, extra = (1, (3 * d + d) * 4) if weights == "int8" else (2, 0)
    ops = {weights: 2 * m * d * 3 * d + 2 * m * d * d}
    ops["bf16"] = ops.get("bf16", 0) + 4 * b * pairs * d
    return ops, 2 * m * d * 2 + 4 * d * d * wb + 6 * d * 4 + extra


def mlp_block_work(b, s, d, f, weights="bf16"):
    m = b * s
    wb, extra = (1, (f + d) * 4) if weights == "int8" else (2, 0)
    return {weights: 4 * m * d * f}, 2 * m * d * 2 + 2 * d * f * wb + (3 * d + f) * 4 + extra


def attention_work(b, h, s, f32, cuda_cores=False):
    """K5: softmax(q k^T / 8 + mask) v over [B, H, S, 64] with an [S, S] f32
    additive mask (every pair is computed: the mask is data).  float32 runs
    3xTF32: three TF32 products per f32 product on the tensor cores
    (``cuda_cores``: f32 FMAs on the CUDA cores, the bound of the design
    that ran them, for comparison)."""
    flops = 4 * b * h * s * s * 64
    ops = ({"f32": flops} if cuda_cores else {"tf32": 3 * flops}) if f32 else {"bf16": flops}
    return ops, 4 * b * h * s * 64 * (4 if f32 else 2) + s * s * 4


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
                      r"(gemm_s8_kernel|gemm_wgmma_kernel|attention_wgmma_kernel|"
                      r"layer_norm_kernel|quant_rows_kernel|attention_f32_kernel|"
                      r"attention_long_kernel)(I(?:Li\d+E|13__nv_bfloat16|f)+E)?", line)
        if m:
            args = [{"13__nv_bfloat16": "bf16", "f": "f32"}.get(a, a.strip("LiE"))
                    for a in re.findall(r"Li\d+E|13__nv_bfloat16|f", m.group(2) or "")]
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"ptxas {lib} {name}: {m.group(1)} registers, {spill} bytes spill stores")
            name = None


def find_cuobjdump():
    import shutil

    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    try:
        import triton

        cand = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                            "cuobjdump")
        return cand if os.path.exists(cand) else None
    except ImportError:
        return None


# SASS instructions each library's design must contain (regex per name):
# bf16 wgmma and TMA loads for K1/K2, s8 wgmma, TMA loads and the bf16
# wgmma core for K3/K4, and for K5 the bf16 wgmma core and the TF32 mma.sync
# of its 3xTF32 float32 routes; and those it must not: no mma.sync (HMMA,
# IMMA) in the int8 library, whose kernels all run on wgmma
SASS_OPS = {"HGMMA": r"\bHGMMA\.", "IGMMA": r"\bIGMMA\.", "UTMALDG": r"\bUTMALDG\b",
            "HMMA.TF32": r"\bHMMA\.[\w.]*TF32\b", "HMMA": r"\bHMMA\.", "IMMA": r"\bIMMA\."}
SASS_REQUIRED = {"fused_block": ("HGMMA", "UTMALDG"),
                 "fused_block_q": ("IGMMA", "UTMALDG", "HGMMA"),
                 "attention": ("HGMMA", "HMMA.TF32")}
SASS_FORBIDDEN = {"fused_block_q": ("HMMA", "IMMA")}


# per kernel of the attention library: each instantiation of the long route
# (attention_long_kernel<T, C>) must hold the instructions of its design and
# none of mma.sync (HMMA.): bf16 wgmma and TMA loads at bf16, tf32 wgmma and
# TMA loads at float32 (3xTF32: Q K^T and P V both on tf32 wgmma)
SASS_LONG = {"bf16": ("HGMMA.BF16", "UTMALDG"), "f32": ("HGMMA.TF32", "UTMALDG")}
SASS_OPS_LONG = {**SASS_OPS, "HGMMA.BF16": r"\bHGMMA\.[\w.]*BF16\b",
                 "HGMMA.TF32": r"\bHGMMA\.[\w.]*TF32\b"}


def sass_functions(path):
    """{mangled kernel name: its SASS} from one cuobjdump -sass of a library
    (the dump, split at each "Function :" header, as -fun gives it kernel by
    kernel); None without cuobjdump."""
    tool = find_cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : ", sass)[1:]
    return {p.split("\n", 1)[0].strip(): p for p in parts}


def sass_check_long(path) -> None:
    """Each instantiation of attention_long_kernel: SASS_LONG[dtype] present,
    no HMMA. (mma.sync); a missing instantiation or form fails the run."""
    funcs = sass_functions(path)
    if funcs is None:
        print("sass long route: no cuobjdump found: the per-kernel forms are not checked")
        return
    seen = {"bf16": 0, "f32": 0}
    for name, body in funcs.items():
        m = re.search(r"attention_long_kernelI(13__nv_bfloat16|f)Li(\d)E", name)
        if not m:
            continue
        dt = "bf16" if m.group(1) == "13__nv_bfloat16" else "f32"
        seen[dt] += 1
        counts = {op: len(re.findall(SASS_OPS_LONG[op], body))
                  for op in SASS_LONG[dt] + ("HMMA",)}
        forms = sorted(set(re.findall(r"\b[HI]G?MMA\.[\w.]+", body)))
        print(f"sass attention_long_kernel<{dt}, hdp {64 * int(m.group(2))}>: {counts}; "
              f"forms {forms}")
        missing = [op for op in SASS_LONG[dt] if counts[op] == 0]
        check(not missing, f"attention_long_kernel<{dt}, {m.group(2)}> has no {missing} "
                           f"instructions in its SASS")
        check(counts["HMMA"] == 0,
              f"attention_long_kernel<{dt}, {m.group(2)}> runs mma.sync (HMMA.)")
    check(seen == {"bf16": 3, "f32": 3},
          f"attention_long_kernel instantiations in the SASS: {seen}, expected 3 each "
          f"(head dims 64, 128, 192)")


def sass_check(lib, path) -> None:
    """Count SASS_OPS in one library's SASS; any of SASS_REQUIRED[lib] at 0,
    or of SASS_FORBIDDEN[lib] above 0, fails the run."""
    tool = find_cuobjdump()
    if tool is None:
        print("sass: no cuobjdump found (PATH, /usr/local/cuda/bin, triton's package): "
              "the wgmma/TMA/TF32 instruction counts are not checked")
        return
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts = {op: len(re.findall(rx, sass)) for op, rx in SASS_OPS.items()}
    forms = sorted(set(re.findall(r"\b[HI]G?MMA\.[\w.]+", sass)))
    print(f"sass {lib} ({os.path.basename(str(path))}): {counts}; forms {forms} "
          f"(cuobjdump {tool})")
    missing = [op for op in SASS_REQUIRED[lib] if counts[op] == 0]
    check(not missing, f"the {lib} library has no {missing} instructions in its SASS")
    present = [op for op in SASS_FORBIDDEN.get(lib, ()) if counts[op] > 0]
    check(not present, f"the {lib} library has {present} (mma.sync) instructions in its SASS")


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


SPLIT_NAMES = {"gemm_wgmma_kernel<0>": "QKV GEMM", "gemm_wgmma_kernel<1>": "out GEMM",
               "gemm_wgmma_kernel<2>": "up GEMM", "gemm_wgmma_kernel<3>": "up GEMM",
               "gemm_wgmma_kernel<4>": "down GEMM", "gemm_s8_kernel<0>": "QKV GEMM",
               "gemm_s8_kernel<1>": "out GEMM", "gemm_s8_kernel<2>": "up GEMM",
               "gemm_s8_kernel<3>": "up GEMM", "gemm_s8_kernel<4>": "down GEMM",
               "layer_norm_kernel": "LN"}
# the int8 attention block quantizes two bf16 row sets (the LN output and
# the attention output) with one kernel at one shape: the profiler sums them
QUANT_X_ATTN = "quantize x + quantize attn (2 calls)"
SPLIT_ORDER = ["LN", "quantize x", QUANT_X_ATTN, "QKV GEMM", "core", "out GEMM", "up GEMM",
               "quantize h", "down GEMM"]


def split_label(key: str) -> str:
    """A block's sub-kernel by its profiler name: the GEMMs by epilogue, the
    quantize pass by its input (bf16 LN output or f32 hidden)."""
    m = re.match(r"^.*?(\w+_kernel)(?:<([^>]*)>)?", key)
    if not m:
        return key
    kernel, args = m.group(1), m.group(2)
    short = f"{kernel}<{args}>" if args else kernel
    if short in SPLIT_NAMES:
        return SPLIT_NAMES[short]
    if kernel == "quant_rows_kernel":
        return "quantize x" if "bfloat16" in (args or "") else "quantize h"
    return "core" if kernel == "attention_wgmma_kernel" else short


def subkernel_split(name, fn, gemm_ops, card, kind="bf16", iters=5, rename=None):
    """ms per call of each device kernel of one block call (torch.profiler),
    and each GEMM's rate and share of the peak for ``kind`` (bf16 or int8);
    ``rename`` maps a sub-kernel's label to the one printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us <= 0:
            continue
        label = split_label(ev.key)
        label = (rename or {}).get(label, label)
        ms = us / iters / 1e3
        text = f"{label} {ms:.4f} ms"
        if label in gemm_ops:
            rate = gemm_ops[label] / ms / 1e9
            unit = "TFLOP/s" if kind == "bf16" else "TOP/s"
            text += f" ({rate:.1f} {unit}, {rate / (PEAK[kind] / 1e12):.1%} of {kind} peak)"
        parts.append((label, ms, text))
    parts.sort(key=lambda p: SPLIT_ORDER.index(p[0]) if p[0] in SPLIT_ORDER else len(SPLIT_ORDER))
    print(f"split {name}: " + "; ".join(p[2] for p in parts)
          + f"; sum {sum(p[1] for p in parts):.4f} ms ({card})")


def kernel_phase(fb, device, card):
    """Kernel vs twin at the B=8 shapes, at every key bucket of the attention
    core, at a ragged M, at the main path's B=256 image shapes (timed, split
    by sub-kernel) and at the text tower's B=319 shapes (timed).  Returns the
    JSON rows without launch counts, and the text-shape times."""
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
    # every key bucket of the wgmma core (32, 80, 200, 256, 256 + 64 keys)
    attn, mlp = block_params(512, device, seed=5)
    for s_ in (1, 7, 257, 320):
        for causal in (False, True):
            x = torch.randn(2, s_, 512, generator=g).to(device, torch.bfloat16)
            compare(f"attention_block B=2 S={s_} D=512 H=8 causal={causal}", x,
                    fb.attention_block(x, *attn, heads=8, causal=causal),
                    fb.attention_block_plain(x, *attn, heads=8, causal=causal))
    # a ragged M: 3 x 77 = 231 rows against the GEMM's 128-row tile
    for scale in (1.0, 1 / 16):
        x = (torch.randn(3, 77, 512, generator=g) * scale).to(device, torch.bfloat16)
        tag = f"B=3 S=77 D=512 x~N(0,{scale}^2) (ragged M)"
        for causal in (False, True):
            compare(f"attention_block {tag} H=8 causal={causal}", x,
                    fb.attention_block(x, *attn, heads=8, causal=causal),
                    fb.attention_block_plain(x, *attn, heads=8, causal=causal))
        for act in fb.ACT_KINDS:
            compare(f"mlp_block {tag} F=2048 {act}", x, fb.mlp_block(x, *mlp, act_kind=act),
                    fb.mlp_block_plain(x, *mlp, act_kind=act))
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
        bound_ms, bound_by = bound(*(attention_block_work(BATCH, 197, 768) if name ==
                                     "attention_block" else mlp_block_work(BATCH, 197, 768, 3072)))
        rows.append({"name": name, "route": "cuda",
                     "source": "debias_vision_lang_torch/csrc/fused_block.cu",
                     "replaces": f"debias_vision_lang_tpu/ops/fused_block.py:{line}",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
    m = BATCH * 197
    subkernel_split(f"attention_block B={BATCH} S=197 D=768 H=12",
                    lambda: fb.attention_block(x, *attn, heads=12),
                    {"QKV GEMM": 2 * m * 768 * 2304, "out GEMM": 2 * m * 768 * 768}, card)
    subkernel_split(f"mlp_block B={BATCH} S=197 D=768 F=3072",
                    lambda: fb.mlp_block(x, *mlp),
                    {"up GEMM": 2 * m * 768 * 3072, "down GEMM": 2 * m * 768 * 3072}, card)
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


def kernel_phase_q(fbq, device, card):
    """attention_block_q / mlp_block_q against their twins at the B=8 shapes
    (x and x/16, and a gelu MLP), attention_block_q at both sides of every
    key bucket of the wgmma core, both blocks at a ragged M (x and x/16;
    causal and not, both activations), at the int8 main path's B=256 image
    shapes (timed; both blocks split by sub-kernel) and at the int8 text
    tower's B=319 shapes (timed).  Returns the JSON rows without launch
    counts, and the text-shape times."""
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
    # both sides of every key bucket of the wgmma core (32, 80, 200, 256,
    # 256 + 64 keys)
    attn, mlp = q_block_params(512, device, seed=5)
    for s_ in (1, 7, 200, 201, 256, 257, 320):
        for causal in (False, True):
            x = torch.randn(2, s_, 512, generator=g).to(device, torch.bfloat16)
            compare(f"attention_block_q B=2 S={s_} D=512 H=8 causal={causal}", *attn_fns, x,
                    attn, {"heads": 8, "causal": causal})
    # a ragged M: 3 x 77 = 231 rows against the s8 GEMM's 128-row tile
    for scale in (1.0, 1 / 16):
        x = (torch.randn(3, 77, 512, generator=g) * scale).to(device, torch.bfloat16)
        tag = f"B=3 S=77 D=512 x~N(0,{scale}^2) (ragged M)"
        for causal in (False, True):
            compare(f"attention_block_q {tag} H=8 causal={causal}", *attn_fns, x, attn,
                    {"heads": 8, "causal": causal})
        for act in ("quick_gelu", "gelu"):
            compare(f"mlp_block_q {tag} F=2048 {act}", *mlp_fns, x, mlp, {"act_kind": act})
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
        bound_ms, bound_by = bound(*(
            attention_block_work(BATCH, 197, 768, weights="int8") if name == "attention_block_q"
            else mlp_block_work(BATCH, 197, 768, 3072, weights="int8")))
        rows.append({"name": name, "route": "cuda",
                     "source": "debias_vision_lang_torch/csrc/fused_block_q.cu",
                     "replaces": f"debias_vision_lang_tpu/ops/fused_block_q.py:{line}",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
    m = BATCH * 197
    subkernel_split(f"attention_block_q B={BATCH} S=197 D=768 H=12",
                    lambda: fbq.attention_block_q(x, *attn[0], heads=12, **attn[1]),
                    {"QKV GEMM": 2 * m * 768 * 2304, "out GEMM": 2 * m * 768 * 768}, card,
                    kind="int8", rename={"quantize x": QUANT_X_ATTN})
    subkernel_split(f"mlp_block_q B={BATCH} S=197 D=768 F=3072",
                    lambda: fbq.mlp_block_q(x, *mlp[0], **mlp[1]),
                    {"up GEMM": 2 * m * 768 * 3072, "down GEMM": 2 * m * 768 * 3072}, card,
                    kind="int8")
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


def kernel_phase_attn(A, device):
    """attention_pallas (K5) against attention_kernel_math, float32 and
    bfloat16: at the image and text shapes and the long route's B=8 and B=32
    H=12 S=785 (timed, beside SDPA), then at both sides of every key bucket of
    the short routes, at the long route's shapes and a ragged B*H (checked
    only).  Every call's launch lands on the route ``_plan`` gives its shape.
    Returns one dict per timed case."""
    import torch
    from debias_vision_lang_torch.models.layers import causal_mask

    g = torch.Generator().manual_seed(3)
    routes = {"short": "attention_pallas", "long": "attention_pallas_long"}

    def run_case(dtype, b, h, s, kind, hd=64, shift=0.0):
        q, k, v = (torch.randn(b, h, s, hd, generator=g).to(device, dtype) for _ in range(3))
        mask = {"zero": lambda: torch.zeros(s, s),
                "random": lambda: torch.randn(s, s, generator=g),
                "causal": lambda: causal_mask(s)}[kind]().add(shift).to(device)
        route = A._plan(s, hd)
        A.reset_launches()
        got = A.attention_pallas(q, k, v, mask)
        launched = dict(A.LAUNCHES)
        ref = A.attention_kernel_math(q, k, v, mask)
        err = (got.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        f32 = dtype == torch.float32
        tol = 2e-5 * mag if f32 else ulp_bf16(mag)
        tag = (f"attention_pallas {'f32' if f32 else 'bf16'} B={b} H={h} S={s}"
               f"{'' if hd == 64 else f' hd={hd}'} mask={kind}"
               f"{f' + {shift:g}' if shift else ''} ({route} route)")
        print(f"kernel {tag}: max_abs_err {err} (tolerance {tol} = "
              f"{'2e-5 x' if f32 else '1 bf16 ulp of'} max |twin| {mag}); launches {launched}")
        check(got.dtype == dtype and got.shape == q.shape and math.isfinite(err) and err <= tol,
              f"{tag}: kernel disagrees with its twin")
        check(launched == {n: int(r == route) for r, n in routes.items()},
              f"{tag}: launches {launched}, expected one on the {route} route")
        return tag, (q, k, v, mask), err, route

    cases = [(8, 12, 197, "zero"), (8, 12, 197, "random"), (64, 12, 197, "zero"),
             (64, 12, 197, "random"), (319, 8, 77, "causal"), (64, 8, 77, "causal"),
             (8, 12, 785, "zero"), (8, 12, 785, "random"), (32, 12, 785, "zero")]
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        for b, h, s, kind in cases:
            tag, (q, k, v, mask), err, route = run_case(dtype, b, h, s, kind)
            lib_mask = mask.to(dtype)
            out.append({"tag": tag, "dtype": "f32" if f32 else "bf16", "b": b, "h": h, "s": s,
                        "mask": kind, "route": route, "err": err,
                        "ms": cuda_ms(lambda: A.attention_pallas(q, k, v, mask)),
                        "plain_ms": cuda_ms(lambda: A.attention_kernel_math(q, k, v, mask)),
                        "library_ms": cuda_ms(lambda: torch.nn.functional.
                                              scaled_dot_product_attention(
                                                  q, k, v, attn_mask=lib_mask)),
                        "bound": bound(*attention_work(b, h, s, f32)),
                        "bound_cuda_cores": bound(*attention_work(b, h, s, f32, True))
                        if f32 else None})
    # both sides of every key bucket of the short routes (32, 80, 200, 256,
    # 320 keys); the long route past 320 keys and at head dims other than
    # 64; and a B*H that is no multiple of anything the kernels tile by
    for dtype in (torch.float32, torch.bfloat16):
        for s in (1, 7, 32, 33, 80, 81, 200, 201, 256, 257, 320):
            for kind in ("zero", "causal"):
                run_case(dtype, 2, 8, s, kind)
        run_case(dtype, 3, 5, 197, "random")
        # the long route: a ragged last key tile, the 127 / 128 / 129-query
        # block edges, 16 and 32 key tiles; head dims padded to 64, 128, 192
        for s in (321, 383, 384, 385, 400, 785, 1025, 2048):
            for kind in ("zero", "random", "causal"):
                run_case(dtype, 2, 8, s, kind)
        for s in (77, 197):
            for hd in (32, 80, 128, 192):
                run_case(dtype, 2, 8, s, "random", hd=hd)
        run_case(dtype, 2, 8, 785, "random", hd=192)
        run_case(dtype, 3, 5, 785, "random")
    # every score shifted by 1e6 (softmax is shift-invariant; the scores'
    # f32 grid is then 1/16): the bf16 long route's exp takes s - max first
    # and must not cancel against a large max
    run_case(torch.bfloat16, 2, 8, 785, "random", shift=1e6)
    torch.cuda.synchronize()
    return out


def long_route_path(A, device):
    """The long route on the path a Frozen-in-Time joint tower runs: 12
    layers of the public op ``attention(..., use_pallas=True)`` (no mask)
    over its 1 + 4 x 196 = 785 tokens at B=8 H=12 head dim 64, each layer
    h = layer_norm(h + attention(h, h, h)); float32 forward and backward (the K5
    training path: the backward differentiates the twin) and bfloat16
    forward.  The launch counters are set to 0 just before each run and
    read just after: 12 launches on the long route, none on the short one.
    Returns {"f32": launches, "bf16": launches}."""
    import torch

    g = torch.Generator().manual_seed(11)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        x0 = torch.randn(8, 12, 785, 64, generator=g).to(device, dtype).requires_grad_(f32)
        torch.cuda.synchronize()
        A.reset_launches()
        h = x0
        with torch.set_grad_enabled(f32):
            for _ in range(LAYERS):
                h = torch.nn.functional.layer_norm(
                    h + A.attention(h, h, h, use_pallas=True), (h.shape[-1],))
            grad = torch.autograd.grad(h.float().square().mean(), x0)[0] if f32 else None
        torch.cuda.synchronize()
        launched = dict(A.LAUNCHES)
        tag = "f32 forward + backward" if f32 else "bf16 forward"
        print(f"K5 long route path (Frozen-in-Time joint tower attention, B=8 H=12 S=785, "
              f"{LAYERS} layers, {tag}): launches {launched}")
        check(launched == {"attention_pallas": 0, "attention_pallas_long": LAYERS},
              f"the long route path launched {launched}, expected {LAYERS} long")
        check(bool(torch.isfinite(h).all()) and (grad is None or bool(torch.isfinite(grad).all())),
              f"the long route path ({tag}) gave non-finite values")
        out["f32" if f32 else "bf16"] = launched["attention_pallas_long"]
    return out


def ingest_path() -> str:
    """Which path decodes image files: the port's native ingest, or PIL when
    this machine lacks the codec headers (libjpeg, libpng) it compiles
    against.  Any other build or load failure of the port's own library
    fails the run: the loaders would hide it behind the Python path."""
    from debias_vision_lang_torch import native

    if native.available():
        print("native ingest: available (decode, resize, crop and staging in C++)")
        return "native ingest"
    err = native.build_error() or ""
    headers = re.findall(r"fatal error: (\w+\.h): No such file", err)
    print(f"native ingest: available False; build error: {err.strip()[-600:]}")
    check(bool(headers) and set(headers) <= {"jpeglib.h", "png.h"},
          "the port's native ingest library failed to build or load for a reason other "
          "than missing codec headers: the loaders would silently take the Python path")
    print(f"native ingest: this machine has no {', '.join(headers)}; image files are decoded "
          f"by PIL, and every wall time below that reads files says so")
    return "PIL decode (no codec headers for the native ingest)"


def reset_all(*modules):
    for m in modules:
        m.reset_launches()


def launches_of(*modules):
    out = {}
    for m in modules:
        out.update(m.LAUNCHES)
    return out


def train_batches(tokenizer, vis, device):
    """TRAIN_STEPS seeded (images, labels, caption images, caption tokens)
    batches, images preprocessed on the card (float32 NHWC)."""
    import torch
    from debias_vision_lang_torch.vision.preprocess import preprocess_batch

    faces = SyntheticFaces(2 * TRAIN_BATCH * TRAIN_STEPS, seed=100)

    def images(start):
        u8 = np.stack([faces.load_image(start + j) for j in range(TRAIN_BATCH)])
        return preprocess_batch(torch.from_numpy(u8).to(device), vis.image_size,
                                mean=vis.image_mean, std=vis.image_std)

    out = []
    for i in range(TRAIN_STEPS):
        base = 2 * TRAIN_BATCH * i
        caps = tokenizer([f"a photo of person number {base + j}" for j in range(TRAIN_BATCH)])
        out.append((images(base), (np.arange(TRAIN_BATCH) % 2).astype(np.float32),
                    images(base + TRAIN_BATCH), caps))
    return out


def run_trainer(model0, sens, batches, counters, **kw):
    """TRAIN_STEPS trainer steps on a copy of ``model0``; the launch counts
    are set to 0 just before and read just after.  ``kw``: use_pallas and
    the TrainConfig fields."""
    import torch
    from debias_vision_lang_torch.models.adversary import Adversary
    from debias_vision_lang_torch.train.adversarial import AdversarialTrainer, TrainConfig

    use_pallas = kw.pop("use_pallas", None)
    model = copy.deepcopy(model0)
    adv = Adversary.from_cfg({"ADV_N_INPUT": len(sens), "ADV_HIDDEN_SIZE": 32, "SEED": 0})
    trainer = AdversarialTrainer.create(model, adv, TrainConfig(batch_size=TRAIN_BATCH, **kw),
                                        sens, use_pallas=use_pallas)
    start = model.debias_tokens.detach().clone()
    metrics, times, updates, grads = [], [], [], []
    adam_step = trainer.prompt_opt.step

    def recording_step(g):  # keeps the first prompt step's token gradient
        if not grads:
            grads.append(g[0].detach().flatten().clone())
        adam_step(g)

    trainer.prompt_opt.step = recording_step
    torch.cuda.synchronize()
    reset_all(*counters)
    for batch in batches:
        before = model.debias_tokens.detach().clone()
        t0 = time.perf_counter()
        metrics.append(trainer.step(*batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        updates.append((model.debias_tokens.detach() - before).flatten())
    counts = launches_of(*counters)
    moved = (model.debias_tokens.detach() - start).abs().max().item()
    return {"trainer": trainer, "model": model, "metrics": metrics, "times": times,
            "updates": updates, "grad": grads[0], "counts": counts, "moved": moved}


def cosine(a, b) -> float:
    import torch

    return torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(),
                                                 dim=0).item()


def check_run(tag, run):
    for i, m in enumerate(run["metrics"]):
        print(f"{tag} step {i + 1}: loss {m['loss']} adv_loss {m['adv_loss']} "
              f"contrastive {m['contrastive_loss']} adversary_bce {m['adversary_bce']} "
              f"({run['times'][i] * 1e3:.1f} ms host clock)")
        check(all(math.isfinite(m[k]) for k in ("loss", "adv_loss", "contrastive_loss",
                                               "adversary_bce")), f"{tag}: non-finite loss")
    print(f"{tag}: launches {run['counts']}; tokens moved by up to {run['moved']}")
    check(run["moved"] > 0, f"{tag}: the prompt array did not move")


def write_fairface(root, n_train, n_val, px=224, seed=0):
    """A seeded synthetic FairFace layout (labels/{mode}/{mode}_labels.csv,
    imgs/train_val/...), genders alternating so the balanced split keeps
    every row."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    races = ["White", "Southeast Asian", "Middle Eastern", "Black", "Indian",
             "Latino_Hispanic", "East Asian"]
    ages = ["0-2", "3-9", "10-19", "20-29", "30-39", "40-49", "50-59", "60-69",
            "more than 70"]
    os.makedirs(os.path.join(root, "imgs", "train_val", "synth"))
    for mode, n in (("train", n_train), ("val", n_val)):
        rows = []
        for i in range(n):
            f = f"synth/{mode}_{i}.jpg"
            Image.fromarray(rng.integers(0, 256, (px, px, 3), dtype=np.uint8)).save(
                os.path.join(root, "imgs", "train_val", f), quality=95)
            rows.append({"file": f, "age": ages[i % 9],
                         "gender": "Male" if i % 2 else "Female", "race": races[i % 7]})
        d = os.path.join(root, "labels", mode)
        os.makedirs(d)
        with open(os.path.join(d, f"{mode}_labels.csv"), "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=["file", "age", "gender", "race"])
            w.writeheader()
            w.writerows(rows)


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
    from debias_vision_lang_torch.ops import attention as A
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
    _build.load_all(["fused_block", "fused_block_q", "attention"])
    fb.build()
    fbq.build()
    A.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS or 'cached'})")
    for lib in ("fused_block", "fused_block_q", "attention"):
        print_ptxas(lib, _build.BUILD_LOG.get(lib, ""))
        sass_check(lib, _build.LIB_PATHS[lib])
    sass_check_long(_build.LIB_PATHS["attention"])

    # 3. bf16 kernels against their twins
    rows, text_ms = kernel_phase(fb, device, card)

    # 4. main path; the port's native ingest is checked first (the library
    # keeps its Python fallback; the measurement does not take it unseen)
    decode = ingest_path()
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
          f"(host clock, includes staging of in-memory uint8 images; {decode} for files); "
          f"launches {launches}")
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
    rows_q, text_ms_q = kernel_phase_q(fbq, device, card)

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

    # 9. K5 against its twin, then its long route on a joint tower's path
    attn_cases = kernel_phase_attn(A, device)
    long_launches = long_route_path(A, device)

    # 10-11. training on the K5 path, the plain float32 path and the bf16
    # fused path, from copies of the phase-4 model
    counters = (fb, fbq, A)
    sens = tokenizer(prompts)
    batches = train_batches(tokenizer, vis, device)
    run_k5 = run_trainer(model, sens, batches, counters, use_pallas=True)
    check_run("train K5 (use_pallas=True, float32)", run_k5)
    k5_per_step = 2 * LAYERS + 3 * LAYERS
    check(run_k5["counts"]["attention_pallas"] == TRAIN_STEPS * k5_per_step,
          f"K5 launched {run_k5['counts']['attention_pallas']} times in {TRAIN_STEPS} "
          f"steps, expected {TRAIN_STEPS * k5_per_step}")
    check(sum(v for k, v in run_k5["counts"].items() if k != "attention_pallas") == 0,
          "the K5 training path launched fused-block kernels")
    k5_model = run_k5.pop("model")
    del run_k5["trainer"]
    run_plain = run_trainer(model, sens, batches, counters, use_pallas=False)
    check_run("train plain (float32)", run_plain)
    check(sum(run_plain["counts"].values()) == 0, "the plain float32 path launched kernels")
    cos_k5 = cosine(run_k5["updates"][0], run_plain["updates"][0])
    cos_k5_g = cosine(run_k5["grad"], run_plain["grad"])
    print(f"first prompt step, K5 path vs plain float32: token gradient cosine "
          f"{cos_k5_g:.7f}, token update cosine {cos_k5:.7f} (bar {UPDATE_COS_K5} on both); "
          f"losses {run_k5['metrics'][0]['loss']} vs {run_plain['metrics'][0]['loss']}")
    check(min(cos_k5, cos_k5_g) >= UPDATE_COS_K5,
          "the K5 path's step drifts from the plain path's")
    del run_plain["trainer"], run_plain["model"], k5_model

    run_bf16 = run_trainer(model, sens, batches, counters, train_dtype="bfloat16",
                           embed_dtype="bfloat16")
    check_run("train bf16 fused blocks", run_bf16)
    want = {"attention_block": TRAIN_STEPS * 2 * LAYERS,
            "attention_block_causal": TRAIN_STEPS * 3 * LAYERS,
            "mlp_block": TRAIN_STEPS * 5 * LAYERS, "attention_pallas": 0,
            "attention_pallas_long": 0, "attention_block_q": 0,
            "attention_block_q_causal": 0, "mlp_block_q": 0}
    check(run_bf16["counts"] == want,
          f"bf16 training launches {run_bf16['counts']}, expected {want}")
    # Adam's first update is ~lr x sign(g): near-zero gradient elements flip
    # its sign, so the update is held by the share of flips, not its cosine
    u16, u32 = run_bf16["updates"][0], run_plain["updates"][0]
    cos_bf16 = cosine(u16, u32)
    flips = (u16.sign() != u32.sign()).double().mean().item()
    cos_bf16_g = cosine(run_bf16["grad"], run_plain["grad"])
    print(f"first prompt step, bf16 vs float32: token gradient cosine {cos_bf16_g:.6f} "
          f"(bar {UPDATE_COS_BF16}), token update sign flips {flips:.6f} of the elements "
          f"(bar {UPDATE_FLIP_MAX_BF16}), token update cosine {cos_bf16:.6f}")
    check(cos_bf16_g >= UPDATE_COS_BF16, "the bf16 gradient drifts from the float32 one")
    check(flips <= UPDATE_FLIP_MAX_BF16, "the bf16 update drifts from the float32 one")
    bf16_model = run_bf16.pop("model")
    del run_bf16["trainer"]
    w = torch.randn(len(prompts), vis.embed_dim, generator=torch.Generator().manual_seed(5)
                    ).to(device)
    grads = {}
    reset_all(*counters)
    for dt in (torch.bfloat16, torch.float32):
        out = bf16_model.encode_text(tokens, dtype=dt).float()
        grads[dt] = torch.autograd.grad((out * w).sum(), bf16_model.debias_tokens)[0]
    torch.cuda.synchronize()
    cos_g = cosine(grads[torch.bfloat16], grads[torch.float32])
    print(f"token gradient of the bf16 text tower (causal K1 launches "
          f"{fb.LAUNCHES['attention_block_causal']}): norm "
          f"{grads[torch.bfloat16].norm().item():.6g}, cosine with float32 {cos_g:.6f}")
    check(fb.LAUNCHES["attention_block_causal"] == LAYERS and grads[torch.bfloat16].norm() > 0
          and cos_g >= UPDATE_COS_BF16, "the bf16 token gradient does not reach the prompts")
    del bf16_model, grads
    torch.cuda.empty_cache()

    # 12. run_training at full width, cached and decoding
    from debias_vision_lang_torch.train.loop import run_training

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        ff_root = os.path.join(tmp, "fairface")
        write_fairface(ff_root, 256, 128)
        print(f"synthetic FairFace (256 train + 128 val at 224 px) written in "
              f"{time.perf_counter() - t0:.2f} s")
        runs = {}
        for cached in (True, False):
            m = copy.deepcopy(model)
            torch.cuda.synchronize()
            reset_all(*counters)
            t0 = time.perf_counter()
            res = run_training(model=m, tokenizer=tokenizer, attribute="gender", epochs=1,
                               batch_size=TRAIN_BATCH, data_path=ff_root,
                               checkpoint_dir=os.path.join(tmp, f"ckpt_{cached}"),
                               eval_every=4, eval_n_samples=None, use_pallas=True,
                               progress=False, cache_frozen_embeddings=cached)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launches_of(*counters)
            export = torch.load(res["export"], map_location="cpu", weights_only=True)
            ckpt = torch.load(os.path.join(res["checkpoint_dir"], "step_4.pt"),
                              map_location="cpu", weights_only=True)
            log = os.path.join(res["checkpoint_dir"], "logs", "metrics.jsonl")
            losses = [r["loss"] for r in map(json.loads, open(log)) if "loss" in r]
            print(f"run_training {'cached' if cached else 'decode'}: {res['steps']} steps "
                  f"in {wall:.2f} s (host clock, includes {decode} and 2 evals), best NDKL "
                  f"{res['best_ndkl']}, losses {losses}, launches {counts}")
            # cached: 4 embed-cache batches x 12 image layers + 4 steps x 36 text;
            # decode: 4 steps x (24 image + 36 text); the evals run float32 plain
            k5 = 4 * LAYERS + 4 * 3 * LAYERS if cached else 4 * 5 * LAYERS
            check(res["steps"] == 4 and res["embed_cache"] is cached,
                  f"run_training {cached}: {res['steps']} steps, cache {res['embed_cache']}")
            check(counts["attention_pallas"] == k5,
                  f"run_training launched K5 {counts['attention_pallas']} times, expected {k5}")
            check(math.isfinite(res["best_ndkl"]) and all(map(math.isfinite, losses)),
                  "run_training: non-finite loss or NDKL")
            check(type(export) is torch.Tensor and export.dtype == torch.float32
                  and tuple(export.shape) == (2, 512) and export.is_contiguous(),
                  f"the .pt export is not a bare [2, 512] float32 tensor: {type(export)}")
            check(ckpt["meta"]["step"] == 4 and torch.equal(ckpt["debias_tokens"],
                                                             m.debias_tokens.detach().cpu()),
                  "the step-4 checkpoint does not hold the trained tokens")
            runs[cached] = (export, losses, wall)
            del m
        diff = (runs[True][0] - runs[False][0]).abs().max().item()
        print(f"run_training cached vs decode: max token difference {diff}, losses "
              f"{'equal' if runs[True][1] == runs[False][1] else 'differ'}")
        check(diff == 0 and runs[True][1] == runs[False][1],
              "the cached and decode runs of run_training end apart")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    # 13. timings
    for row, counts in [(r, launches) for r in rows] + [(r, launches_q) for r in rows_q]:
        row["launches"] = counts[row["name"]]
        print(f"time {row['name']} B={BATCH} S=197 D=768: kernel {row['ms']:.4f} ms, "
              f"plain twin {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; the kernel at {row['bound_ms'] / row['ms']:.1%} of it) "
              f"({card})")
    text_work = {"attention_block causal": attention_block_work(319, 77, 512, causal=True),
                 "mlp_block": mlp_block_work(319, 77, 512, 2048),
                 "attention_block_q causal": attention_block_work(319, 77, 512, causal=True,
                                                                  weights="int8"),
                 "mlp_block_q": mlp_block_work(319, 77, 512, 2048, weights="int8")}
    for name, (k_ms, p_ms) in {**text_ms, **text_ms_q}.items():
        b_ms, b_by = bound(*text_work[name])
        print(f"time {name} B=319 S=77 D=512: kernel {k_ms:.4f} ms, plain twin "
              f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; the kernel at "
              f"{b_ms / k_ms:.1%} of it) ({card})")
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
    for c in attn_cases:
        old = (f"; CUDA-core bound {c['bound_cuda_cores'][0]:.4f} ms "
               f"({c['bound_cuda_cores'][1]}), had the products run as f32 FMAs"
               if c["bound_cuda_cores"] else "")
        print(f"time {c['tag']}: kernel {c['ms']:.4f} ms, plain twin {c['plain_ms']:.4f} ms, "
              f"scaled_dot_product_attention {c['library_ms']:.4f} ms, bound "
              f"{c['bound'][0]:.4f} ms ({c['bound'][1]}; the kernel at "
              f"{c['bound'][0] / c['ms']:.1%} of it{old}) ({card})")
    for tag, run in (("plain float32", run_plain), ("K5 (use_pallas=True) float32", run_k5),
                     ("bf16 kernels", run_bf16)):
        steady = sum(run["times"][1:]) / len(run["times"][1:]) * 1e3
        print(f"train step B={TRAIN_BATCH} + 319 prompts, {tag}: {steady:.1f} ms/step "
              f"(mean of steps 2-{TRAIN_STEPS}; all {[round(t * 1e3, 1) for t in run['times']]}"
              f"; host clock) ({card})")
    for cached in (True, False):
        print(f"run_training {'cached' if cached else 'decode'}: {runs[cached][2]:.2f} s "
              f"({decode}; {card})")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    rows_k5 = []
    for b, s, mask in ((319, 77, "causal"), (64, 197, "zero")):
        k5 = next(c for c in attn_cases
                  if c["dtype"] == "f32" and (c["b"], c["s"], c["mask"]) == (b, s, mask))
        check(k5["route"] == "short", f"{k5['tag']}: the main path's shapes take the short route")
        rows_k5.append({"name": "attention_pallas", "case": k5["tag"], "route": "cuda",
                        "source": "debias_vision_lang_torch/csrc/attention.cu",
                        "replaces": "debias_vision_lang_tpu/ops/attention.py:93",
                        "launches": run_k5["counts"]["attention_pallas"],
                        "max_abs_err": k5["err"], "ms": k5["ms"],
                        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound"][0],
                        "bound_by": k5["bound"][1], "library_ms": k5["library_ms"]})
    for dt in ("f32", "bf16"):
        k5 = next(c for c in attn_cases
                  if c["dtype"] == dt and (c["b"], c["s"], c["mask"]) == (8, 785, "zero"))
        check(k5["route"] == "long", f"{k5['tag']}: S = 785 takes the long route")
        rows_k5.append({"name": "attention_pallas_long", "case": k5["tag"], "route": "cuda",
                        "source": "debias_vision_lang_torch/csrc/attention.cu",
                        "replaces": "debias_vision_lang_tpu/ops/attention.py:93",
                        "launches": long_launches[dt], "max_abs_err": k5["err"], "ms": k5["ms"],
                        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound"][0],
                        "bound_by": k5["bound"][1], "library_ms": k5["library_ms"]})
    print(json.dumps({"kernels": rows + rows_q + rows_k5}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
