#!/usr/bin/env python3
"""Ablation of K5's long route (csrc/attention.cu::attention_long_kernel) on
one CUDA card: the kernel as built beside copies with one design choice
taken back, each built from a text substitution of the checked-in source,
timed at H=12 S=785 head dim 64 (a Frozen-in-Time joint tower's attention)
with a zero mask, B=8 and B=32, bfloat16 and float32.

    python3 benchmarks_torch/long_route_ablation.py

Variants (a substitution that no longer matches the source fails the run):
  as built       the checked-in kernel
  one block/SM   bf16 at head dim 64 with one block per SM and deeper rings
                 (3 mask, 4 K, 4 V slots) instead of two blocks
  exp_acc bf16   bf16 with the accurate exp of the f32 route (exp_acc, ~2
                 ulp) instead of one FMA and ex2.approx
  expf           both dtypes on the libm expf
  exp branch     f32 with a branch per element for -inf instead of a clamp
  pass 1 only    pass 2 skipped (time only: the output is not the function)
  no mask reads  the mask tiles loaded but not read (time only)
Every variant but the last two is checked against the twin at the bars of
chip_smoke.py (2e-5 of the largest magnitude at f32, one bf16 ulp).  Times:
CUDA events over 20 launches after a warm-up, ms per call, the kernel's
C entry point called directly (no wrapper copies).  Prints the card's
nvidia-smi name and power limit.  Exits 2 without a card.
"""

import ctypes
import math
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "debias_vision_lang_torch", "csrc")

EXACT = True  # the variant computes the function (checked against the twin)
VARIANTS = {
    "as built": (EXACT, []),
    "one block/SM": (EXACT, [
        ("static constexpr int BLOCKS = (!F32 && C == 1) ? 2 : 1;",
         "static constexpr int BLOCKS = 1;"),
        ("static constexpr int DM = F32 ? 2 : (C == 1 ? 2 : 3);",
         "static constexpr int DM = F32 ? 2 : 3;"),
        ("static constexpr int DK = F32 ? 2 : (C == 1 ? 2 : 6);",
         "static constexpr int DK = F32 ? 2 : (C == 1 ? 4 : 6);"),
        ("(C == 1 ? 1 : C == 2 ? 4 : 3)", "(C == 1 ? 4 : C == 2 ? 4 : 3)")]),
    "exp_acc bf16": (EXACT, [("expm<F32>", "expm<true>")]),
    "expf": (EXACT, [("expm<F32>", "expm<true>"),
                     ("  return p * fmaf(lo, 0.693147181f, 1.0f);", "  return expf(x);")]),
    "exp branch": (EXACT, [("    return exp_acc(fmaxf(x - m, -104.f));",
                            "    return x == -INFINITY ? 0.f : exp_acc(x - m);")]),
    "pass 1 only": (not EXACT, [
        ("  for (int kt = 0; kt < nkt; ++kt) {\n    scores(sc, kt);\n#pragma unroll\n"
         "    for (int nt = 0; nt < 8; ++nt) {\n      sc[nt * 4] = expm",
         "  for (int kt = 0; kt < 0; ++kt) {\n    scores(sc, kt);\n#pragma unroll\n"
         "    for (int nt = 0; nt < 8; ++nt) {\n      sc[nt * 4] = expm"),
        ("      for (int kt = 0; kt < nkt; ++kt) {\n        int s = rm.put",
         "      for (int kt = 0; kt < (pass == 1 ? 0 : nkt); ++kt) {\n        int s = rm.put")]),
    "no mask reads": (not EXACT, [
        ("      const float2 mlo = *reinterpret_cast<const float2*>(mb + swz(r_lo, cb));\n"
         "      const float2 mhi = *reinterpret_cast<const float2*>(mb + swz(r_hi, cb));",
         "      const float2 mlo = make_float2(0.f, 0.f), mhi = mlo;\n"
         "      (void)mb;\n      (void)cb;")]),
}


def build(out_dir):
    sys.path.insert(0, ROOT)
    from debias_vision_lang_torch.ops import _build

    src = open(os.path.join(CSRC, "attention.cu")).read()
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: the source no longer holds {old[:70]!r}")
            text = text.replace(old, new)
        tag = name.replace(" ", "_").replace("/", "_")
        cu = os.path.join(out_dir, f"{tag}.cu")
        open(cu, "w").write(text)
        cmd = [_build.find_nvcc(), *_build.nvcc_flags(), "-o", os.path.join(out_dir, f"{tag}.so"),
               cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tag)
    libs = {}
    for name, (p, tag) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{tag}.so"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dvl_attention.argtypes = [vp] * 5 + [i] * 5 + [ctypes.c_float, vp,
                                                          ctypes.c_longlong, vp]
        lib.dvl_attention.restype = i
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("long_route_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from debias_vision_lang_torch.ops import attention as A

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(tempfile.mkdtemp(prefix="long_route_ablation_"))
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    s, h, hd = 785, 12, 64

    def call(lib, q, k, v, mask, out):
        b = q.shape[0]
        err = lib.dvl_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                                out.data_ptr(), b * h, s, hd, int(q.dtype == torch.bfloat16), 1,
                                ctypes.c_float(1 / math.sqrt(hd)), None, 0,
                                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"dvl_attention: CUDA error {err}")

    def ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        for b in (8, 32):
            q, k, v = (torch.randn(b, h, s, hd, generator=g).to(dev, dtype) for _ in range(3))
            mask = torch.zeros(s, s, device=dev)
            lmask = A._long_route_mask(mask).contiguous()
            ref = A.attention_kernel_math(q, k, v, mask).float()
            mag = ref.abs().max().item()
            tol = 2e-5 * mag if f32 else 2.0 ** (math.floor(math.log2(mag)) - 7)
            cells = []
            for name, lib in libs.items():
                out = torch.empty_like(q)
                call(lib, q, k, v, lmask, out)
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item()
                t = ms(lambda: call(lib, q, k, v, lmask, out))
                if VARIANTS[name][0]:
                    good = math.isfinite(err) and err <= tol
                    ok &= good
                    cells.append(f"{name} {t:.4f} (err/bar {err / tol:.3f})")
                else:
                    cells.append(f"{name} {t:.4f} (time only)")
            print(f"{'f32' if f32 else 'bf16'} B={b} H={h} S={s}: " + " | ".join(cells)
                  + f" ({card})", flush=True)
    print(card)
    if not ok:
        print("long_route_ablation: a variant that computes the function missed its bar",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
