"""Path constants (reference: debias_clip/__init__.py:21-23).

The port's own copy of ``debias_vision_lang_tpu/core/paths.py``, with the
same names and environment variables.  The reference resolves a ``data/``
directory shipped next to the package and derives the FairFace root and
prompt-template CSV from it; the variables override each path.
"""

from __future__ import annotations

import os
import pathlib

# repo-root/assets is the data dir of a source checkout (prompt templates,
# tokenizer vocab).
DATA_PATH = pathlib.Path(
    os.environ.get(
        "DEBIAS_VLT_DATA_PATH",
        str((pathlib.Path(__file__) / ".." / ".." / ".." / "assets").resolve()),
    )
).resolve()

FAIRFACE_DATA_PATH = pathlib.Path(
    os.environ.get("DEBIAS_VLT_FAIRFACE_PATH", str(DATA_PATH / "fairface"))
)

UTKFACE_DATA_PATH = pathlib.Path(
    os.environ.get("DEBIAS_VLT_UTKFACE_PATH", str(DATA_PATH / "utkface"))
)

PROMPT_DATA_PATH = DATA_PATH / "prompt_templates.csv"

# The static protocol files also ship inside the port's package (an install
# has no repo-root assets/): DATA_PATH first, then this copy.
PACKAGE_ASSETS = (pathlib.Path(__file__) / ".." / ".." / "assets").resolve()


def resolve_asset(name: str) -> pathlib.Path:
    """Locate a static packaged asset by name (prompt CSV, template lists)."""
    candidate = DATA_PATH / name
    if candidate.exists():
        return candidate
    packaged = PACKAGE_ASSETS / name
    if packaged.exists():
        return packaged
    raise FileNotFoundError(
        f"asset {name!r} not found in {DATA_PATH} or {PACKAGE_ASSETS}")


BPE_VOCAB_PATH = pathlib.Path(
    os.environ.get("DEBIAS_VLT_BPE_PATH", str(DATA_PATH / "bpe_simple_vocab_16e6.txt.gz"))
)

CACHE_PATH = pathlib.Path(
    os.environ.get(
        "DEBIAS_VLT_CACHE_PATH", os.path.expanduser("~/.cache/debias_vision_lang_torch")
    )
)
