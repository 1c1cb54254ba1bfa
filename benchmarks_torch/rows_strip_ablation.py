#!/usr/bin/env python3
"""Where the time of ``rows_strip_q_kernel`` (the int8 row-parallel product's
row-strip kernel, csrc/fused_block_q.cu) goes, on one CUDA card: the kernel
built as it is and with one part of its work taken out at a time, each a
textual edit of a scratch copy of the source, timed on ViT-B/16's cases at
B=256 S=197 D=768 (the m = 2 attention slot's bf16 rows at K = 384, the m = 8
slots' at K = 128 and 64, the m = 8 MLP slot's f32 hidden at K = 384).

Variants:

  full        the kernel as it is
  no_store    no TMA store of the int32 tiles (staged, not sent)
  no_quant    the quantizer warpgroups read and code nothing (the strip keeps
              whatever it holds; the products still run)
  no_aq       the codes and scales are not written out (the strip still is)
  no_mma      no s8 wgmma (the accumulators stay zero)
  store_only  no quantize, no products, no codes out: the int32 stores alone

A variant's outputs are wrong by design; only its time is read.  Each is
compiled with the library's own nvcc flags into ``build/ablation/<name>/``
(one nvcc each, started together) and called through its
``dvl_rows_q_partial`` on the strip route: CUDA-event wall of 20 calls, the
median of 5 runs, beside the bytes bound (chip_smoke.py::tp_rows_q_work at
3.35 TB/s).  An edit whose text is no longer in the source stops the run
(exit 1): the variants must follow the kernel.

    python3 benchmarks_torch/rows_strip_ablation.py

Prints the card's nvidia-smi name and power limit.  Exits 2 without a card.
"""

import ctypes
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = pathlib.Path(__file__).resolve().parents[1]
CSRC = HERE / "debias_vision_lang_torch" / "csrc"
OUT = HERE / "build" / "ablation"

NO_QUANT = ("for (int i0 = tid; i0 < total; i0 += 128 * UNR) {",
            "for (int i0 = tid; i0 < 0; i0 += 128 * UNR) {")
NO_MMA = ("for (int kk = 0; kk < SBK / 32; ++kk) wgmma_ss_s8_n128(acc, da + 2 * kk, db + 2 * kk);",
          "")
NO_AQ = ("const bool writer = u % groups == 0;", "const bool writer = false;")
EDITS = {
    "full": [],
    "no_store": [("if (col0 < ldc)\n              tma_store_2d_hint(&tm_c, out_stage + bx * (64 * 128), "
                  "col0, r0, evict_first);", "")],
    "no_quant": [NO_QUANT],
    "no_aq": [NO_AQ],
    "no_mma": [NO_MMA],
    "store_only": [NO_QUANT, NO_MMA, NO_AQ],
}
# (label, K, input dtype, slots m)
CASES = (("m=2 attention K=384 bf16", 384, "bf16", 2), ("m=8 attention K=128 bf16", 128, "bf16", 8),
         ("m=8 attention K=64 bf16", 64, "bf16", 8), ("m=8 MLP K=384 f32", 384, "f32", 8))
M, N = 256 * 197, 768


def variant_source(name: str) -> str:
    src = (CSRC / "fused_block_q.cu").read_text()
    for old, new in EDITS[name]:
        if old not in src:
            raise SystemExit(f"rows_strip_ablation: the {name} edit no longer matches "
                             f"csrc/fused_block_q.cu ({old!r})")
        src = src.replace(old, new)
    return src


def build(name: str):
    from debias_vision_lang_torch.ops import _build

    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(CSRC, d)
    (d / "fused_block_q.cu").write_text(variant_source(name))
    so = d / "libfused_block_q.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.nvcc_flags(d), "-o", str(so),
                           str(d / "fused_block_q.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"rows_strip_ablation: nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    return name, so


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("rows_strip_ablation: no CUDA device found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    for name in EDITS:  # every edit applies before anything builds
        variant_source(name)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with ThreadPoolExecutor(len(EDITS)) as pool:
        libs = dict(pool.map(build, list(EDITS)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(20):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / 20

    p, i = ctypes.c_void_p, ctypes.c_int
    entries = {}
    for name, so in libs.items():
        f = ctypes.CDLL(str(so)).dvl_rows_q_partial
        f.argtypes = [p, i, p, i, p, p, p, p, i, i, i, i, i, p]
        f.restype = i
        entries[name] = f
    for label, k, dt, m in CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        a = (torch.randn(M, k, generator=gen, device=dev) * 0.5).to(dtype)
        amaxes = [a.float().abs().amax(-1) * (1 + j / m) for j in range(m)]
        ptrs = (ctypes.c_void_p * m)(*[t.data_ptr() for t in amaxes])
        wt = torch.randint(-127, 128, (N, k), generator=gen, device=dev, dtype=torch.int8)
        aq = torch.empty(M, k, dtype=torch.int8, device=dev)
        ascale = torch.empty(M, dtype=torch.float32, device=dev)
        out = torch.empty(M, N, dtype=torch.int32, device=dev)
        nbytes = M * k * a.element_size() + 4 * M * m + M * k + 4 * M + k * N + 4 * M * N
        times = []
        for name, f in entries.items():
            def call(f=f):
                err = f(a.data_ptr(), int(dt == "f32"), ptrs, m, wt.data_ptr(), aq.data_ptr(),
                        ascale.data_ptr(), out.data_ptr(), M, N, k, N, 1,
                        torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: dvl_rows_q_partial returned {err}")

            times.append(f"{name} {statistics.median(wall(call) for _ in range(5)):.4f}")
        print(f"rows_strip_q_kernel ViT-B/16 B=256 S=197 D=768 {label}: bytes bound "
              f"{nbytes / 3.35e12 * 1e3:.4f} ms; ms " + "; ".join(times) + f" ({card})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
