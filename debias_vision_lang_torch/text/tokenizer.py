"""CLIP tokenizer: text → fixed-shape ``[B, 77]`` int32 token ids (the
port's own copy of ``debias_vision_lang_tpu/text/tokenizer.py``, held to it
by tests/test_torch_standalone.py).

The reference consumes ``clip.tokenize`` as an opaque callable
(reference: debias_clip/model/model.py:113, debias_clip/measuring_bias.py:77).
This module provides the same surface (``tokenize(texts) -> [B, 77]``),
returning numpy int32 (host-side).

Vocab loading: the real CLIP merges file
(``bpe_simple_vocab_16e6.txt.gz``) is data, not code; it is looked up at
``assets/`` or ``$DEBIAS_VLT_BPE_PATH``; the JAX package's
``data/download.py`` fetches it on a machine with network (the port
downloads nothing).  Everything here works with any merges file, so tests
use a small synthetic vocabulary.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Union

import numpy as np
import regex as re

from ..core.paths import BPE_VOCAB_PATH
from .bpe import BPE, EOT_TEXT, SOT_TEXT, build_vocab, bytes_to_unicode, read_merges
from .cleaning import clean

# CLIP's pre-tokenization pattern: specials, contractions, letter runs,
# single digits, punctuation runs.
_TOKEN_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)


class ClipTokenizer:
    def __init__(self, merges, context_length: int = 77):
        self.bpe = BPE(merges)
        self.encoder = build_vocab(merges)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.context_length = context_length
        self.sot_token = self.encoder[SOT_TEXT]
        self.eot_token = self.encoder[EOT_TEXT]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = clean(text).lower()
        for chunk in _TOKEN_PATTERN.findall(text):
            chunk = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            ids.extend(self.encoder[sym] for sym in self.bpe(chunk).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Union[str, Sequence[str]], truncate: bool = False) -> np.ndarray:
        return self.tokenize(texts, truncate=truncate)

    def tokenize(
        self, texts: Union[str, Sequence[str]], truncate: bool = False
    ) -> np.ndarray:
        """SOT + bpe(text) + EOT, zero-padded to ``[B, context_length]`` int32.

        Over-long inputs raise unless ``truncate``; truncation keeps SOT and
        forces the final slot to EOT (matching ``clip.tokenize`` semantics).
        """
        if isinstance(texts, str):
            texts = [texts]
        n = self.context_length
        out = np.zeros((len(texts), n), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(ids) > n:
                if not truncate:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length {n}"
                    )
                ids = ids[:n]
                ids[-1] = self.eot_token
            out[i, : len(ids)] = ids
        return out


_DEFAULT_TOKENIZER = None


def load_tokenizer(path: os.PathLike = None, context_length: int = 77) -> ClipTokenizer:
    """Load the CLIP tokenizer from a merges file (default: packaged path)."""
    path = str(path or BPE_VOCAB_PATH)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"BPE merges file not found at {path}. Run "
            f"`python -m debias_vision_lang_tpu.data.download bpe` on a machine "
            f"with network access, or set $DEBIAS_VLT_BPE_PATH."
        )
    return ClipTokenizer(read_merges(path), context_length=context_length)


def tokenize(texts, truncate: bool = False) -> np.ndarray:
    """Module-level convenience mirroring ``clip.tokenize``."""
    global _DEFAULT_TOKENIZER
    if _DEFAULT_TOKENIZER is None:
        _DEFAULT_TOKENIZER = load_tokenizer()
    return _DEFAULT_TOKENIZER.tokenize(texts, truncate=truncate)
