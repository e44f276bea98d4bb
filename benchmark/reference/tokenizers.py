"""The benchmark's own tokenizers, handed to the program and used by the
reference alike (no checkpoint vocabulary and no jieba are on the card's
machine)."""

from __future__ import annotations

import re

SPARSE_TOKEN = re.compile(r"[^\s/#]+")


class CharTokenizer:
    """One token per character, ``ord(c) % (vocab - 2) + 2``; bos 1, pad 0,
    right padding (as the bge-reranker-v2-minicpm-layerwise checkpoint
    declares)."""

    bos_token_id = 1
    pad_token_id = 0
    padding_side = "right"

    def __init__(self, vocab: int) -> None:
        self.vocab = vocab

    def __call__(self, text, add_special_tokens=False, max_length=None, truncation=False):
        ids = [ord(ch) % (self.vocab - 2) + 2 for ch in text]
        return {"input_ids": ids[:max_length] if truncation and max_length else ids}


class SparseTokenizer:
    """Splits the synthetic corpus's words and know-path parts on blanks,
    ``/`` and ``#``."""

    def cut(self, text):
        return SPARSE_TOKEN.findall(text)

