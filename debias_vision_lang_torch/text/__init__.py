"""Tokenizers for the port.

The CLIP BPE tokenizer is the port's own copy (``bpe.py``, ``cleaning.py``,
``tokenizer.py``, as in the JAX package; it needs ``regex`` and the BPE
vocabulary file).
``ByteTokenizer`` needs neither: UTF-8 bytes as ids 0..255 between CLIP's
start (49406) and end (49407) ids, padded with 0 to the context length.  The
end id is the largest id, so EOT pooling (argmax) finds it; it drives the
towers where the vocabulary is absent, with ids that are not CLIP's BPE ids.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

SOT_ID = 49406
EOT_ID = 49407


class ByteTokenizer:
    def __init__(self, context_length: int = 77):
        self.context_length = context_length

    def __call__(self, texts: Union[str, Sequence[str]],
                 truncate: bool = False) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_length), np.int64)
        for i, text in enumerate(texts):
            ids = [SOT_ID, *text.encode("utf-8"), EOT_ID]
            if len(ids) > self.context_length:
                if not truncate:
                    raise RuntimeError(f"input {text!r} is too long for context "
                                       f"length {self.context_length}")
                ids = ids[: self.context_length - 1] + [EOT_ID]
            out[i, : len(ids)] = ids
        return out


def load_bpe_tokenizer(context_length: int = 77):
    """The CLIP BPE tokenizer, or None when ``regex`` or the vocabulary is
    missing."""
    try:
        from .tokenizer import load_tokenizer

        return load_tokenizer(context_length=context_length)
    except (ImportError, FileNotFoundError):
        return None
