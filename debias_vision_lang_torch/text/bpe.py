"""Byte-pair encoding core, compatible with OpenAI CLIP's BPE (the port's own
copy of ``debias_vision_lang_tpu/text/bpe.py``).

Implemented from the BPE algorithm description (Sennrich et al. 2016) and the
CLIP vocabulary format: a gzip'd merges file whose first line is a version
header, followed by merge rules in priority order.  The vocabulary is
byte-level: 256 base symbols (bytes remapped to printable unicode), their
``</w>`` end-of-word variants, one token per merge, and two specials —
49,408 entries total for the real CLIP vocab.

Token-id compatibility matters downstream: the EOT token must be the largest
id because the reference pools text features at ``text.argmax(-1)``
(reference: debias_clip/model/model.py:265).  This construction guarantees
that for any merges file.
"""

from __future__ import annotations

import functools
import gzip
from typing import Dict, List, Sequence, Tuple

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Bijective map from byte values to printable unicode characters.

    Printable ASCII/latin bytes map to themselves; the rest are remapped to
    the 256.. range so every byte has a visible, non-whitespace symbol.  This
    must match GPT-2/CLIP's construction exactly for id parity.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def get_pairs(word: Tuple[str, ...]) -> set:
    """Set of adjacent symbol pairs in a word."""
    return set(zip(word[:-1], word[1:]))


def read_merges(path: str, limit: int = 48894) -> List[Tuple[str, str]]:
    """Read a CLIP-format merges file (gzip or plain text).

    The real file's first line is a version header; CLIP uses merges
    1..48894+1 (so the final vocab is 49,408 = 2*256 + 48,894 + 2).
    """
    if str(path).endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            raw = f.read()
    else:
        with open(path, encoding="utf-8") as f:
            raw = f.read()
    lines = raw.split("\n")
    lines = lines[1 : limit + 1]
    merges = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        a, b = line.split()
        merges.append((a, b))
    return merges


def build_vocab(merges: Sequence[Tuple[str, str]]) -> Dict[str, int]:
    """Token string → id.  SOT/EOT are always the last two ids."""
    base = list(bytes_to_unicode().values())
    tokens = base + [v + "</w>" for v in base]
    tokens.extend(a + b for a, b in merges)
    tokens.append(SOT_TEXT)
    tokens.append(EOT_TEXT)
    return {tok: i for i, tok in enumerate(tokens)}


class BPE:
    """Stateful BPE encoder over a fixed merge table."""

    def __init__(self, merges: Sequence[Tuple[str, str]]):
        self.ranks: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}

    def __call__(self, token: str) -> str:
        """Apply merges to one pre-tokenized chunk; returns space-joined symbols."""
        cached = self.cache.get(token)
        if cached is not None:
            return cached

        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if bigram not in self.ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)

        result = " ".join(word)
        self.cache[token] = result
        return result
