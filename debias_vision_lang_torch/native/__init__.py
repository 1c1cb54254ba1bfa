"""Native host-ingest runtime (C++ / libjpeg) with ctypes bindings: the
port's own copy of ``debias_vision_lang_tpu/native`` (``ingest.cc`` the same
source), built from this directory's ``ingest.cc`` into the git-ignored
``build/native/`` beside the package.

The reference's host pipeline is native code it inherits from dependencies
(PIL's C JPEG decoder + torchvision transforms inside DataLoader worker
processes — reference: debias_clip/measuring_bias.py:142,
debias_clip/datasets.py:122).  This package is the framework's own native
equivalent: ``ingest.cc`` implements decode → bit-exact PIL fixed-point
bicubic resize → center-crop → normalize with an internal thread pool; this
module builds it on demand (one g++ invocation, cached in ``build/native/``
or ``$DVL_NATIVE_CACHE``) and exposes numpy-facing wrappers.

Everything degrades gracefully: if g++ or libjpeg is unavailable,
``available()`` returns False and callers fall back to the pure-Python host
path (vision/preprocess.py), which is the bit-exactness oracle the C++ is
tested against.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "ingest.cc")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERR: Optional[str] = None


BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(_SRC)))),
    "build", "native")


def _lib_path() -> str:
    cache = os.environ.get("DVL_NATIVE_CACHE") or BUILD_DIR
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, "libdvl_ingest.so")


def ensure_built(force: bool = False) -> str:
    """Compile ingest.cc if the shared object is missing or stale.

    Returns the .so path; raises RuntimeError on compile failure."""
    so = _lib_path()
    if (not force and os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(_SRC)):
        return so
    # per-process tmp name: two processes building concurrently must not
    # interleave g++ output into one file (os.replace is atomic, so the
    # last finisher wins with a COMPLETE library either way)
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC,
           "-ljpeg", "-lpng", "-lpthread", "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(f"native ingest build failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, so)
    return so


# must match dvl_version() in ingest.cc; a cached .so from an older source
# (possible when install tools reset mtimes) binds as stale and is rebuilt
_EXPECTED_ABI = 3


def _bind(lib: ctypes.CDLL) -> None:
    """Declare argtypes for every export.  Raises AttributeError when the
    library predates a symbol (stale cached build)."""
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_ip = ctypes.POINTER(ctypes.c_int)
    c_fp = ctypes.POINTER(ctypes.c_float)
    lib.dvl_version.argtypes = []
    lib.dvl_version.restype = ctypes.c_int
    lib.dvl_decode_jpeg.argtypes = [c_u8p, ctypes.c_size_t, c_u8p,
                                    ctypes.c_size_t, c_ip, c_ip]
    lib.dvl_jpeg_dims.argtypes = [c_u8p, ctypes.c_size_t, c_ip, c_ip]
    lib.dvl_resize_bicubic_u8.argtypes = [
        c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        c_u8p, ctypes.c_int, ctypes.c_int]
    lib.dvl_preprocess_u8.argtypes = [c_u8p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, c_fp]
    lib.dvl_preprocess_batch_u8.argtypes = [
        ctypes.POINTER(c_u8p), c_ip, c_ip, ctypes.c_int, ctypes.c_int,
        c_fp, ctypes.c_int]
    lib.dvl_preprocess_batch_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        c_fp, c_ip, ctypes.c_int]
    lib.dvl_ingest_batch_files_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        c_u8p, c_ip, ctypes.c_int]
    lib.dvl_ingest_batch_files_u8p.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, c_u8p, c_ip, ctypes.c_int]
    lib.dvl_ingest_batch_mem_u8.argtypes = [
        ctypes.POINTER(c_u8p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, c_u8p, c_ip,
        ctypes.c_int]
    lib.dvl_ingest_batch_mem_u8p.argtypes = [
        ctypes.POINTER(c_u8p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        c_u8p, c_ip, ctypes.c_int]
    if lib.dvl_version() != _EXPECTED_ABI:
        raise AttributeError(
            f"native ABI {lib.dvl_version()} != expected {_EXPECTED_ABI}")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_ERR
    with _LOCK:
        if _LIB is not None or _BUILD_ERR is not None:
            return _LIB
        for rebuild in (False, True):
            lib = None
            try:
                lib = ctypes.CDLL(ensure_built(force=rebuild))
                _bind(lib)
            except (AttributeError, OSError) as e:
                if lib is not None:
                    # drop the stale mapping: dlopen caches by pathname,
                    # so without dlclose the rebuilt file at the same path
                    # would resolve to the old handle
                    try:
                        import _ctypes

                        _ctypes.dlclose(lib._handle)
                    except Exception:
                        pass
                # AttributeError: cached .so predates a newer export / ABI
                # bump (the mtime comparison misses this when install tools
                # reset mtimes).  OSError: corrupt/unloadable cached file.
                # Rebuild from source once, then give up gracefully —
                # callers fall back to the Python path.
                if not rebuild:
                    continue
                _BUILD_ERR = f"unusable native library: {e}"
                return None
            except (RuntimeError, subprocess.SubprocessError) as e:
                # compile itself failed — retrying the same compile is
                # pointless
                _BUILD_ERR = str(e)
                return None
            _LIB = lib
            return _LIB
        return None


def available() -> bool:
    """True when the native library is built (or buildable) and loadable."""
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _BUILD_ERR


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def jpeg_dims(data: bytes) -> tuple:
    """JPEG bytes → (height, width) from the header alone (no pixel
    decode) — the cheap pre-allocation size check for decode caps."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_BUILD_ERR}")
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.dvl_jpeg_dims(_u8p(buf), buf.size, ctypes.byref(h),
                           ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"not a decodable JPEG (rc={rc})")
    return h.value, w.value


def decode_jpeg(data: bytes, dims=None) -> np.ndarray:
    """JPEG bytes → uint8 [H, W, 3] RGB (libjpeg, PIL-equivalent defaults).

    ``dims``: optional pre-computed ``(h, w)`` from ``jpeg_dims`` — callers
    that already header-checked (size caps) skip the re-parse."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_BUILD_ERR}")
    buf = np.frombuffer(data, np.uint8)
    hv, wv = dims if dims is not None else jpeg_dims(data)
    h, w = ctypes.c_int(hv), ctypes.c_int(wv)
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.dvl_decode_jpeg(_u8p(buf), buf.size, _u8p(out), out.size,
                             ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def resize_bicubic_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bit-exact PIL fixed-point bicubic resize (uint8 [H, W, C])."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_BUILD_ERR}")
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.uint8)
    rc = lib.dvl_resize_bicubic_u8(_u8p(img), h, w, c, _u8p(out), out_h, out_w)
    if rc != 0:
        raise ValueError(f"resize failed (rc={rc})")
    return out


def preprocess_u8(img: np.ndarray, n_px: int = 224) -> np.ndarray:
    """Full reference chain on one decoded image → float32 [n_px, n_px, 3]."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_BUILD_ERR}")
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    out = np.empty((n_px, n_px, 3), np.float32)
    rc = lib.dvl_preprocess_u8(_u8p(img), h, w, n_px,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"preprocess failed (rc={rc})")
    return out


def preprocess_batch_files(paths: Sequence[str], n_px: int = 224,
                           nthreads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Read+decode+preprocess JPEG files → (float32 [N, n_px, n_px, 3],
    bool ok[N]).  Failed entries are zero-filled with ok=False."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_BUILD_ERR}")
    n = len(paths)
    if nthreads <= 0:
        nthreads = min(8, 2 * (os.cpu_count() or 1))
    out = np.zeros((n, n_px, n_px, 3), np.float32)
    ok = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.dvl_preprocess_batch_files(
        arr, n, n_px, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nthreads)
    return out, ok.astype(bool)


def ingest_batch_files_u8(paths: Sequence[str], n_px: int = 224,
                          nthreads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Read+decode+resize+crop JPEG files to uint8 [N, n_px, n_px, 3] —
    the staging variant for on-device normalize (4× less H2D than f32)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_BUILD_ERR}")
    n = len(paths)
    if nthreads <= 0:
        nthreads = min(8, 2 * (os.cpu_count() or 1))
    out = np.zeros((n, n_px, n_px, 3), np.uint8)
    ok = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.dvl_ingest_batch_files_u8(
        arr, n, n_px, _u8p(out),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nthreads)
    return out, ok.astype(bool)


def ingest_batch_files_u8p(paths: Sequence[str], n_px: int = 224,
                           patch: int = 16,
                           nthreads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Read+decode+resize+crop JPEG files to PATCH-CONTIGUOUS uint8
    [N, (n_px/patch)², patch²·3] — the staging layout the exact int8 stem
    consumes directly (ops/quant.py::patch_embed_q_p8).  Same bytes as
    ``ingest_batch_files_u8`` rearranged for free at write time."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_BUILD_ERR}")
    if patch <= 0 or n_px % patch != 0:
        raise ValueError(f"n_px={n_px} not divisible by patch={patch}")
    n = len(paths)
    if nthreads <= 0:
        nthreads = min(8, 2 * (os.cpu_count() or 1))
    g = n_px // patch
    out = np.zeros((n, g * g, patch * patch * 3), np.uint8)
    ok = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.dvl_ingest_batch_files_u8p(
        arr, n, n_px, patch, _u8p(out),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nthreads)
    return out, ok.astype(bool)


def _mem_batch_args(blobs: Sequence[bytes]):
    """(buf-pointer array, length array, pinned numpy views) for the
    in-memory batch entry points.  The views are returned so callers keep
    them alive across the C call (ctypes pointers don't own the buffers)."""
    n = len(blobs)
    views = [np.frombuffer(b, np.uint8) for b in blobs]
    bufs = (ctypes.POINTER(ctypes.c_uint8) * n)(*[_u8p(v) for v in views])
    lens = (ctypes.c_size_t * n)(*[v.size for v in views])
    return bufs, lens, views


def ingest_batch_mem_u8(blobs: Sequence[bytes], n_px: int = 224,
                        max_pixels: int = 0,
                        nthreads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Decode+resize+crop IN-MEMORY encoded images (JPEG/PNG) to uint8
    [N, n_px, n_px, 3] in one threaded native call — the serving raw-JPEG
    request path.  ``max_pixels`` > 0 rejects images whose HEADER h·w
    exceeds it (ok=False) before any pixel decode."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_BUILD_ERR}")
    n = len(blobs)
    if nthreads <= 0:
        nthreads = min(8, 2 * (os.cpu_count() or 1))
    out = np.zeros((n, n_px, n_px, 3), np.uint8)
    ok = np.zeros(n, np.int32)
    bufs, lens, _views = _mem_batch_args(blobs)
    lib.dvl_ingest_batch_mem_u8(
        bufs, lens, n, n_px, max_pixels, _u8p(out),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nthreads)
    return out, ok.astype(bool)


def ingest_batch_mem_u8p(blobs: Sequence[bytes], n_px: int = 224,
                         patch: int = 16, max_pixels: int = 0,
                         nthreads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Same in-memory chain written PATCH-CONTIGUOUSLY
    [N, (n_px/patch)², patch²·3] — the exact staging the relayout-free
    int8/bf16 stems consume (ops/quant.py::patch_embed_q_p8), produced
    directly at decode time so serving skips the host patchify entirely."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_BUILD_ERR}")
    if patch <= 0 or n_px % patch != 0:
        raise ValueError(f"n_px={n_px} not divisible by patch={patch}")
    n = len(blobs)
    if nthreads <= 0:
        nthreads = min(8, 2 * (os.cpu_count() or 1))
    g = n_px // patch
    out = np.zeros((n, g * g, patch * patch * 3), np.uint8)
    ok = np.zeros(n, np.int32)
    bufs, lens, _views = _mem_batch_args(blobs)
    lib.dvl_ingest_batch_mem_u8p(
        bufs, lens, n, n_px, patch, max_pixels, _u8p(out),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nthreads)
    return out, ok.astype(bool)
