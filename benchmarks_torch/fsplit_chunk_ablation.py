#!/usr/bin/env python3
"""Where the time of K4's F-split down product goes, on one CUDA card: the
port built as it is and with one change at a time, each a textual edit of a
scratch copy of ``csrc/fused_block_q.cu``, the F-split timed at ViT-B/16
B=256 (fb = 1,536, 1,024 and 768) by ``mlp_q_split.py --split --no-digests
--fsplit-only`` on each copy.

Variants (the edits touch ``gemm_s8_epi_chunk_kernel``, the chunked
epilogue-warpgroup GEMM, unless named otherwise):

  epi         the kernel as it is, on every fb (the route rule's chunk
              floor lifted, so fb = 768 takes it too)
  no_fold     the epilogue warpgroups wait for each chunk and hand it back
              but fold nothing into the sums
  no_dump     the consumers hand each chunk off without writing the int32
              tile to the half buffer
  gemm        gemm_s8_kernel's chunked mode (EQ_RESID_BIAS_CHUNK), as the
              route rule's other side runs it: one block an SM
  gemm_2blk   that mode at two blocks an SM (its launch bounds' block count
              2; the f32 sum beside the accumulators then spills)

A variant's outputs are wrong by design where its edit drops work; only
its time is read.  Each copy goes to ``build/fsplit_ablation/<name>/``, and
its library is compiled there (one nvcc each, started together) before the
timing runs, one after another.  An edit whose text is no longer in the
source stops the run (exit 1): the variants must follow the kernel.

    python3 benchmarks_torch/fsplit_chunk_ablation.py [variant ...]

Prints the card's nvidia-smi name and power limit.  Exits 2 without a card.
"""

import os
import pathlib
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
PKG = "debias_vision_lang_torch"
OUT = HERE / "build" / "fsplit_ablation"
KERNEL = ("gemm_s8_epi_chunk_kernel(const __grid_constant__", "bool fsplit_down_fits(int D")
RULE = ("return layer_down_fits(D) && chunk % SBK == 0 && chunk >= FSPLIT_MIN_STEPS * SBK;",)
EDITS = {  # name: [(old, new, whole file?)]
    "epi": [(RULE[0], "return layer_down_fits(D) && chunk % SBK == 0;", True)],
    "no_fold": [(RULE[0], "return layer_down_fits(D) && chunk % SBK == 0;", True),
                ("      mbar_wait(&dumped[e], hand & 1);\n#pragma unroll\n"
                 "      for (int k = 0; k < 8; ++k) {",
                 "      mbar_wait(&dumped[e], hand & 1);\n#pragma unroll\n"
                 "      for (int k = 0; k < 0; ++k) {", False)],
    "no_dump": [(RULE[0], "return layer_down_fits(D) && chunk % SBK == 0;", True),
                ("            *reinterpret_cast<int2*>(half + te_half_offset(warp * 16 + g + 8 * h, "
                 "8 * j + 2 * t)) =\n                make_int2(acc[4 * j + 2 * h], "
                 "acc[4 * j + 2 * h + 1]);", "            ;", False)],
    "gemm": [(RULE[0], "return false;", True)],
    "gemm_2blk": [(RULE[0], "return false;", True),
                  ("__launch_bounds__(SGEMM_THREADS, EPI == EQ_RESID_BIAS_CHUNK ? 1 : 2)",
                   "__launch_bounds__(SGEMM_THREADS, 2)", True)],
}


def variant_source(name: str) -> str:
    src = (HERE / PKG / "csrc" / "fused_block_q.cu").read_text()
    lo, hi = src.index(KERNEL[0]), src.index(KERNEL[1])
    for old, new, whole in EDITS[name]:
        part = src if whole else src[lo:hi]
        if part.count(old) != 1:
            raise SystemExit(f"fsplit_chunk_ablation: the {name} edit no longer matches "
                             f"csrc/fused_block_q.cu once ({old!r})")
        if whole:
            src = src.replace(old, new)
        else:
            src = src[:lo] + part.replace(old, new) + src[hi:]
        lo, hi = src.index(KERNEL[0]), src.index(KERNEL[1])
    return src


def make_copy(name: str) -> pathlib.Path:
    root = OUT / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(HERE / PKG, root / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    (root / PKG / "csrc" / "fused_block_q.cu").write_text(variant_source(name))
    return root


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("fsplit_chunk_ablation: no CUDA device found", file=sys.stderr)
        return 2
    names = (argv if argv is not None else sys.argv[1:]) or list(EDITS)
    roots = {name: make_copy(name) for name in names}
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from debias_vision_lang_torch.ops import _build; _build.load('fused_block_q')")
    procs = {n: subprocess.Popen([sys.executable, "-c", build, str(r)]) for n, r in roots.items()}
    failed = [n for n, p in procs.items() if p.wait() != 0]
    if failed:
        print(f"fsplit_chunk_ablation: the build of {failed} failed", file=sys.stderr)
        return 1
    split = HERE / "benchmarks_torch" / "mlp_q_split.py"
    for name, root in roots.items():
        proc = subprocess.run([sys.executable, str(split), "--root", str(root), "--label", name,
                               "--split", "--no-digests", "--fsplit-only"],
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if "F-split" in line or "library" in line:
                print(line, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
