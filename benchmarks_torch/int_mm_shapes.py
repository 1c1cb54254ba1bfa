#!/usr/bin/env python3
"""Which int8 GEMM shapes ``torch._int_mm`` (cuBLAS) takes on this card.

    python3 benchmarks_torch/int_mm_shapes.py

The ResNet int8 rung's im2col GEMMs have a short K (27 padded to 32 for the
stem's first conv) and millions of rows; RN50x4's stem has 40 output
channels.  For N in {32, 40, 48, 56, 64, 80, 96, 160}, K in {32, 80, 360}
and M in {4,096, 2,000,000}, prints whether the product runs and, where it
does, whether its first 64 rows equal the exact int32 product on the CPU.
On an H100 N = 40 and 56 are refused (CUBLAS_STATUS_NOT_SUPPORTED) at K = 32
and 80 and 2 M rows; every N that is a multiple of 16 runs, which is why
``ops/quant_resnet.py`` pads N to one.
"""

import itertools
import subprocess
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("int_mm_shapes: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip()
    for n_out, k, rows in itertools.product((32, 40, 48, 56, 64, 80, 96, 160), (32, 80, 360),
                                            (4096, 2_000_000)):
        a = torch.randint(-127, 127, (rows, k), dtype=torch.int8, device="cuda")
        w = torch.randint(-127, 127, (n_out, k), dtype=torch.int8, device="cuda")
        try:
            out = torch._int_mm(a, w.t())
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"N={n_out} K={k} M={rows}: refused ({str(e).splitlines()[0][:80]})")
            continue
        exact = torch.equal(out[:64].cpu(), a[:64].cpu().int() @ w.cpu().int().t())
        print(f"N={n_out} K={k} M={rows}: runs, first 64 rows exact: {exact}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
