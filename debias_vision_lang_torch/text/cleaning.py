"""Text cleaning for CLIP BPE tokenization (the port's own copy of
``debias_vision_lang_tpu/text/cleaning.py``).

CLIP's tokenizer cleans text with ``ftfy.fix_text`` + double HTML-unescape,
then collapses whitespace and lowercases (behavior consumed by the reference
via ``clip.tokenize``, call sites reference: debias_clip/model/model.py:113,186
and debias_clip/measuring_bias.py:77).

``ftfy`` is an optional dependency here: when it is importable we use it (bit
parity with OpenAI's pipeline); otherwise we fall back to a lite cleaner that
is exact for all ASCII and correctly-encoded Unicode input — mojibake *repair*
(ftfy's specialty) is the only divergence, and the framework's shipped prompt
set (assets/prompt_templates.csv, 319 prompts) is pure ASCII, where the two
are identical.
"""

from __future__ import annotations

import html
import unicodedata

try:  # pragma: no cover - environment dependent
    import ftfy

    def _fix_text(text: str) -> str:
        return ftfy.fix_text(text)

    HAVE_FTFY = True
except ImportError:  # pragma: no cover - environment dependent
    def _fix_text(text: str) -> str:
        # NFC-normalize; real ftfy also repairs mojibake, which cannot be
        # replicated without its heuristics. Exact for well-formed input.
        return unicodedata.normalize("NFC", text)

    HAVE_FTFY = False

import regex as re

_WHITESPACE_RE = re.compile(r"\s+")


def basic_clean(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return _WHITESPACE_RE.sub(" ", text).strip()


def clean(text: str) -> str:
    """Full CLIP cleaning chain (lowercasing happens in the tokenizer)."""
    return whitespace_clean(basic_clean(text))
