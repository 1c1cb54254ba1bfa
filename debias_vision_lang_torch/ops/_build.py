"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source into a shared library with a plain C
interface for ``sm_90a``; ``ctypes`` loads it.  The library is built at
first use into ``build/kernels/`` beside the package, named by a hash of
the source and flags, so an edited source rebuilds and an unchanged one
loads in milliseconds.
Nothing here runs at import time: the CPU-only test environment imports
every module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict = {}
# seconds spent in nvcc per source, and its resource report (-Xptxas -v)
BUILD_SECONDS: dict = {}
BUILD_LOG: dict = {}


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "compiled from csrc/ at first use on a GPU machine")


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = CSRC / f"{name}.cu"
        flags = ARCH_FLAGS + NVCC_FLAGS
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        if not so.exists():
            tmp = so.with_suffix(f".tmp{os.getpid()}")
            cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_SECONDS[name] = time.perf_counter() - t0
            BUILD_LOG[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name}:\n{proc.stderr[-4000:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _LIBS[name] = lib
        return lib
