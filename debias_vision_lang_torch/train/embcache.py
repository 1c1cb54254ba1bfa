"""Disk persistence for the training loop's frozen-tower embedding cache.

Counterpart of ``debias_vision_lang_tpu/train/embcache.py`` (which imports
jax's tree utilities).  With ``TrainConfig.embedding_cache_dir`` set, the
rows that ``run_training`` embeds once per call are kept across calls (the
sweep workflow), keyed by content fingerprints:

* the tower's parameters: every state-dict entry's name, shape, dtype and
  content digest (``utils/fingerprint.py``, reduced on the device);
* the dataset rows: file paths RELATIVE to the dataset root, in order, and
  the encoded labels (moving the dataset keeps the key); the loop adds each
  file's (size, mtime) (``files_fingerprint``), so a file rewritten under
  the same name misses;
* the embed dtype, the resolution and the implementation.

A mismatched or unreadable file is a miss (recomputed, and rewritten
atomically through ``.part`` + ``os.replace``), never trusted.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..utils.fingerprint import params_fingerprint

__all__ = [
    "params_fingerprint", "dataset_fingerprint", "files_fingerprint",
    "file_sha256", "cache_load", "cache_store", "cache_path",
]


def dataset_fingerprint(ds) -> str:
    """sha256 over the rows' identity: ordered file paths relative to the
    dataset root (``ds.data_path``) and the encoded labels."""
    root = getattr(ds, "data_path", None)
    h = hashlib.sha256()
    for f in ds._img_fnames:
        h.update(str(os.path.relpath(f, root) if root else f).encode())
        h.update(b"\0")
    h.update(np.ascontiguousarray(np.asarray(ds.iat_labels)).tobytes())
    return h.hexdigest()


def files_fingerprint(paths: Sequence[str]) -> str:
    """sha256 over each file's (size, mtime in ns), in order: a file
    rewritten in place under the same name changes it."""
    h = hashlib.sha256()
    for p in paths:
        st = os.stat(p)
        h.update(f"{st.st_size}:{st.st_mtime_ns}\0".encode())
    return h.hexdigest()


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _key_json(key_fields: Dict) -> str:
    return json.dumps(key_fields, sort_keys=True, default=str)


def cache_path(cache_dir: str, kind: str, key_fields: Dict) -> str:
    """The key's hash is in the file name, so configs coexist in one dir."""
    digest = hashlib.sha256(_key_json(key_fields).encode()).hexdigest()[:32]
    return os.path.join(cache_dir, f"{kind}_{digest}.npz")


def cache_load(path: str, key_fields: Dict) -> Optional[Dict[str, np.ndarray]]:
    """The stored arrays on a validated hit; None on any miss (absent,
    unreadable, or stored under another key)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as data:
            if "cache_key" not in data or str(data["cache_key"]) != _key_json(key_fields):
                return None
            return {k: data[k] for k in data.files if k != "cache_key"}
    except Exception:
        return None


def cache_store(path: str, key_fields: Dict, **arrays) -> None:
    """Atomic staged write (.part + os.replace)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        np.savez(f, cache_key=_key_json(key_fields), **arrays)
    os.replace(tmp, path)
