#!/usr/bin/env python3
"""Where the time of KB (a) 1's int8 core goes, stage by stage, on one CUDA
card: csrc/attention_qq.cuh as checked in beside copies that stop after a
stage or change one choice, each built from a text substitution of a
checkout's header into a small library of its own (the header and
``launch_attention_qq`` behind a C entry; nvcc, one process per copy, all
started together), and timed on the same seeded f32 qkv.

    python3 benchmarks_torch/qq_core_split.py [--root CHECKOUT]

The header's design picks the copies: the s8 wgmma design (as checked in):
  register route (attention_qq_kernel<224>, B=256 S=197 D=768 H=12):
    quantize        the main kernel returns at once
    no P V          the products of P V taken out (p's codes still packed)
    no writes       the output stores taken out
  tiled route (attention_qq_tiled_kernel<64>, B=32 S=785 D=768 H=12):
    quantize        the main kernel returns at once
    pass 1          pass 2 taken out (its tiles not loaded)
    no P V          the products of P V taken out
    2 / 4 blocks    two or four blocks an SM instead of three (the
                    registers a thread follow: 168 / 102)
The mma.sync design this one replaced (``--root`` a checkout of it), each
copy stopping at a point of the main kernel:
  register route (attention_qq_kernel, B=256 S=197 D=768 H=12):
    quantize        after q, k and v are quantized into shared memory
    + softmax       after the scores, the softmax and p's codes (no P V)
    + P V           after the int32 P V (no output written)
  tiled route (attention_qq_tiled_kernel, B=32 S=785 D=768 H=12; its two
  quantize pre-passes run in every copy):
    pre-passes      the main kernel returns at once
    + pass 1        after pass 1 (row max and sum)
    + pass 2 no P V pass 2's scores, p and codes, the products of P V taken
                    out (the V^T chunks still staged)
    + P V           after pass 2 (no output written)
A stopped copy keeps what it computed alive through a store that runs only
for a negative scale (never here), so the compiler drops none of it.  The
difference between two neighbouring rows is the stage's time.  A
substitution that no longer matches the header fails the run; "as built"
runs on any checkout.  Times: CUDA events over 20 calls after a warm-up.
Prints the card's nvidia-smi name and power limit.  Exits 2 without a card.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WRAPPER = r"""
#include "attention_qq.cuh"
extern "C" {
int qq_core(const void* qkv, void* out, void* ws, int B, int S, int heads, int hdp, float scale,
            void* stream) {
  return (int)launch_attention_qq(static_cast<const float*>(qkv), static_cast<bf16*>(out),
                                  nullptr, nullptr, nullptr, ws, B, S, heads, hdp,
                                  3 * heads * hdp, scale, reinterpret_cast<cudaStream_t>(stream));
}
long long qq_ws(int B, int S, int heads, int hdp) { return qq_ws_bytes(B, S, heads, hdp); }
}
"""

REG_STOP_QUANT = (
    "  int8_t* Pw = Pc + warp * 16 * LDV;\n",
    "  if (scale < 0.f)\n"
    "    out[tid] = __float2bfloat16((float)Qc[tid] + (float)Kc[tid] + (float)Vt[tid] + qsc[tid] +\n"
    "                                ksc[tid] + vsc[tid & 63]);\n"
    "  return;\n"
    "  int8_t* Pw = Pc + warp * 16 * LDV;\n")
REG_STOP_SOFTMAX = (
    "    // int32 P V over the padded keys (p and v codes past S are zero)\n",
    "    if (scale < 0.f) out[tid] = __float2bfloat16((float)Pw[lane] + ps_lo + ps_hi);\n"
    "    continue;\n")
REG_STOP_PV = (
    "    // (o * p scale) * v scale, rounded to bf16\n",
    "    {\n      int acc = 0;\n#pragma unroll\n      for (int n = 0; n < 8; ++n) acc += o[n][0] ^ o[n][1] ^ o[n][2] ^ o[n][3];\n"
    "      if (scale < 0.f) out[tid] = __float2bfloat16((float)acc + ps_lo + ps_hi);\n"
    "      continue;\n    }\n")
TILED_STOP_NOW = (
    "  const int nkt = Sp / QQ_TILE;\n",
    "  const int nkt = Sp / QQ_TILE;\n  if (scale >= 0.f) return;\n")
TILED_STOP_PASS1 = (
    "  // 2. p, its codes, and int32 P V over the head's output chunk grp\n",
    "  if (scale < 0.f) out[tid] = __float2bfloat16(ps_lo + ps_hi + m_lo + m_hi);\n  return;\n")
TILED_NO_PV = (
    "        mma_s8_16832(o[n], pa, ld_u32(vr), ld_u32(vr + 16));\n",
    "        o[n][0] += (int)(pa[0] ^ pa[1] ^ pa[2] ^ pa[3]) + (int)vr[0];\n")
TILED_STOP_PV = (
    "  // (o * p scale) * v scale, rounded to bf16, at the head's output chunk\n",
    "  {\n    int acc = 0;\n#pragma unroll\n    for (int n = 0; n < 8; ++n) acc += o[n][0] ^ o[n][1] ^ o[n][2] ^ o[n][3];\n"
    "    if (scale < 0.f) out[tid] = __float2bfloat16((float)acc + ps_lo + ps_hi);\n"
    "    return;\n  }\n")

# the s8 wgmma design
W_REG_QUANT = (
    "  const int nv = Sp / QQ_TILE < Cfg::NV ? Sp / QQ_TILE : Cfg::NV;",
    "  if (scale >= 0.f) return;\n  const int nv = Sp / QQ_TILE < Cfg::NV ? Sp / QQ_TILE : Cfg::NV;")
W_REG_NO_PV = (
    "      wgmma_rs_s8<64>(o, *reinterpret_cast<const uint32_t(*)[4]>(&pa[4 * ks]),\n"
    "                      dv + (ks >> 1) * (QQ_BOX >> 4) + (ks & 1) * 2);\n",
    "      o[ks] += (int)(pa[4 * ks] ^ pa[4 * ks + 1] ^ pa[4 * ks + 2] ^ pa[4 * ks + 3]);\n")
W_REG_NO_WRITES = (
    "      if (q0 + row < S)\n",
    "      if (q0 + row < S && scale < 0.f)\n")
W_TILED_QUANT = (
    "  const int cq = hdp / QQ_TILE, nkt = Sp / QQ_TILE;\n",
    "  const int cq = hdp / QQ_TILE, nkt = Sp / QQ_TILE;\n  if (scale >= 0.f) return;\n")
W_TILED_PASS1 = [
    ("    for (int pass = pass1 ? 0 : 1; pass < (pass2 ? 2 : 1); ++pass)",
     "    for (int pass = pass1 ? 0 : 1; pass < 1; ++pass)"),
    ("  const long long srow = (long long)bh * Sp + q0;  // this tile's first statistics row\n",
     "  if (scale >= 0.f) {\n    if (l_lo < 0.f) out[tid] = __float2bfloat16(m_lo + m_hi + l_hi);\n"
     "    return;\n  }\n"
     "  const long long srow = (long long)bh * Sp + q0;  // this tile's first statistics row\n")]
W_TILED_NO_PV = (
    "    wgmma_rs_s8<NO>(o, *reinterpret_cast<const uint32_t(*)[4]>(&pa[0]), dv);\n"
    "    wgmma_rs_s8<NO>(o, *reinterpret_cast<const uint32_t(*)[4]>(&pa[4]), dv + 2);\n",
    "    o[kt & 7] += (int)(pa[0] ^ pa[1] ^ pa[2] ^ pa[3] ^ pa[4] ^ pa[5] ^ pa[6] ^ pa[7]);\n")


def w_blocks(n):
    return ("  static constexpr int BLOCKS = NO == 64 ? 3 : NO == 128 ? 2 : 1;",
            f"  static constexpr int BLOCKS = NO == 64 ? {n} : NO == 128 ? 2 : 1;")


# name: (shape index, substitutions), per design
WGMMA_VARIANTS = {
    "register: quantize": (0, [W_REG_QUANT]),
    "register: no P V": (0, [W_REG_NO_PV]),
    "register: no writes": (0, [W_REG_NO_WRITES]),
    "register: as built": (0, []),
    "tiled: quantize": (1, [W_TILED_QUANT]),
    "tiled: pass 1": (1, W_TILED_PASS1),
    "tiled: no P V": (1, [W_TILED_NO_PV]),
    "tiled: 2 blocks an SM": (1, [w_blocks(2)]),
    "tiled: 4 blocks an SM": (1, [w_blocks(4)]),
    "tiled: as built": (1, []),
}
MMA_SYNC_VARIANTS = {
    "register: quantize": (0, [REG_STOP_QUANT]),
    "register: + softmax": (0, [REG_STOP_SOFTMAX]),
    "register: + P V": (0, [REG_STOP_PV]),
    "register: as built": (0, []),
    "tiled: pre-passes": (1, [TILED_STOP_NOW]),
    "tiled: + pass 1": (1, [TILED_STOP_PASS1]),
    "tiled: + pass 2 no P V": (1, [TILED_NO_PV, TILED_STOP_PV]),
    "tiled: + P V": (1, [TILED_STOP_PV]),
    "tiled: as built": (1, []),
}
SHAPES = ((256, 197, 768, 12), (32, 785, 768, 12))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def build(csrc, out_dir, nvcc, flags, variants):
    header = open(os.path.join(csrc, "attention_qq.cuh")).read()
    jobs = {}
    for name, (_, subs) in variants.items():
        text = header
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: the header no longer holds {old[:70]!r}")
            text = text.replace(old, new)
        tag = re.sub(r"\W+", "_", name).strip("_")
        src_dir = os.path.join(out_dir, tag)
        os.makedirs(src_dir)
        for f in os.listdir(csrc):
            if f.endswith(".cuh") and f != "attention_qq.cuh":
                with open(os.path.join(csrc, f)) as a, open(os.path.join(src_dir, f), "w") as b:
                    b.write(a.read())
        with open(os.path.join(src_dir, "attention_qq.cuh"), "w") as f:
            f.write(text)
        with open(os.path.join(src_dir, "qq_split.cu"), "w") as f:
            f.write(WRAPPER)
        jobs[name] = (src_dir, os.path.join(out_dir, f"lib{tag}.so"))

    def one(item):
        name, (src_dir, so) = item
        cmd = [nvcc, *flags, "-I", src_dir, "-o", so, os.path.join(src_dir, "qq_split.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{proc.stderr[-3000:]}")
        regs = re.findall(r"Compiling entry function '\w*?(attention_qq_\w*?kernel\w*?)'"
                          r"(?:(?!Compiling entry).)*?Used (\d+) registers",
                          proc.stdout + proc.stderr, re.S)
        return name, so, regs

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return list(pool.map(one, jobs.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose header is split")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("qq_core_split: no CUDA device found", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from debias_vision_lang_torch.ops import _build

    csrc = os.path.join(os.path.abspath(args.root), "debias_vision_lang_torch", "csrc")
    mma_sync = "mma.sync" in open(os.path.join(csrc, "attention_qq.cuh")).read()
    variants = MMA_SYNC_VARIANTS if mma_sync else WGMMA_VARIANTS
    name = card()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        built = build(csrc, tmp, _build.find_nvcc(), _build.ARCH_FLAGS + _build.NVCC_FLAGS,
                      variants)
        inputs = {}
        for i, (b, s, d, h) in enumerate(SHAPES):
            g = torch.Generator(device=dev).manual_seed(1000 * s + d)
            inputs[i] = torch.randn(b * s, 3 * d, generator=g, device=dev)
        for vname, so, regs in built:
            i = variants[vname][0]
            b, s, d, h = SHAPES[i]
            lib = ctypes.CDLL(so)
            p, n = ctypes.c_void_p, ctypes.c_int
            lib.qq_core.argtypes = [p, p, p, n, n, n, n, ctypes.c_float, p]
            lib.qq_core.restype = n
            lib.qq_ws.argtypes = [n, n, n, n]
            lib.qq_ws.restype = ctypes.c_longlong
            out = torch.zeros(b * s, d, dtype=torch.bfloat16, device=dev)
            ws = torch.empty(max(lib.qq_ws(b, s, h, 64), 256), dtype=torch.uint8, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                err = lib.qq_core(inputs[i].data_ptr(), out.data_ptr(), ws.data_ptr(), b, s, h,
                                  64, 0.125, stream)
                if err:
                    raise RuntimeError(f"{vname}: launch error {err}")

            call()
            torch.cuda.synchronize()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(20):
                call()
            t1.record()
            t1.synchronize()
            ms = t0.elapsed_time(t1) / 20
            print(f"split {vname} B={b} S={s} D={d} H={h}: {ms:.4f} ms; registers "
                  f"{', '.join(f'{k}: {r}' for k, r in regs)} ({name})", flush=True)
    print(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
