"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source into a shared library with a plain C
interface for ``sm_90a``; ``ctypes`` loads it.  The library is built at
first use into ``build/kernels/`` beside the package, named by a hash of
the source, every shared header (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one loads in
milliseconds.  ``load_all`` starts one ``nvcc`` per source at once.
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
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()
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


def nvcc_flags(csrc: pathlib.Path = CSRC) -> List[str]:
    return ARCH_FLAGS + NVCC_FLAGS + ["-I", str(csrc)]


def source_digest(csrc: pathlib.Path, name: str, flags: Sequence[str]) -> str:
    """Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` (name and bytes) and
    the flags: any edit a build could see names a new library."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _lock(name: str) -> threading.Lock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(name, threading.Lock())


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    with _lock(name):
        if name in _LIBS:
            return _LIBS[name]
        src = CSRC / f"{name}.cu"
        flags = nvcc_flags()
        digest = source_digest(CSRC, name, flags)
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


def load_all(names: Sequence[str]) -> List[ctypes.CDLL]:
    """``load`` every source, one ``nvcc`` each, all started together."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(load, names))
