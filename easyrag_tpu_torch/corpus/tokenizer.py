"""Chinese tokenization for the sparse route, plus splitter token counters.

Query/corpus tokenization must be *bit-compatible* with the reference or
BM25 recall parity fails: jieba default-mode cut with a dedicated
``jieba.Tokenizer()`` instance (``src/easyrag/pipeline/pipeline.py:177-178``),
then removal of HIT stopwords and the single-space token
(``src/easyrag/custom/retrievers.py:72-76``).

The splitter additionally needs a *token counter* to measure chunk sizes.
llama-index defaults to tiktoken's gpt-3.5-turbo encoding
(``llama_index.core.utils.get_tokenizer``); tiktoken normally downloads its
BPE table, so the counter resolves in order: a vendored
``cl100k_base.tiktoken`` table (exact, offline; fetch once with
``tools/vendor_cl100k.py``), tiktoken's own cache/network path (exact), then
a deterministic CJK-aware approximation (1 token per CJK char, ASCII
word-pieces of ~4 chars). The selection is logged and queryable
(:func:`token_counter_info`) because it decides chunk boundaries; the
approximation changes boundaries relative to the reference — acceptable only
because chunking feeds both systems identically when comparing retrieval
parity on the same chunk set, and the counter is pluggable for exact
reproduction.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Callable, Iterable, List, Set

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")


def load_stopwords(path: str) -> Set[str]:
    """Load a stopword file, one word per line, stripped
    (``pipeline.py:28-31``)."""
    with open(path, "r", encoding="utf-8") as f:
        return {line.strip() for line in f}


def default_stopwords() -> Set[str]:
    """The packaged HIT Chinese stopword list (767 entries)."""
    with open(os.path.join(_DATA_DIR, "stopwords_hit.json"), encoding="utf-8") as f:
        obj = json.load(f)
    return set(obj["words"])


class JiebaTokenizer:
    """Thread-safe wrapper over a dedicated ``jieba.Tokenizer`` instance.

    Default mode (HMM on, not cut_all), matching ``jieba.Tokenizer().cut``
    as used by the reference sparse retriever.
    """

    def __init__(self) -> None:
        import jieba

        self._tk = jieba.Tokenizer()
        self._lock = threading.Lock()

    def cut(self, text: str) -> List[str]:
        with self._lock:
            return list(self._tk.cut(text))

    def __call__(self, text: str) -> List[str]:
        return self.cut(text)


def tokenize_and_remove_stopwords(
    tokenizer, text: str, stopwords: Iterable[str]
) -> List[str]:
    """jieba cut + stopword and single-space removal
    (``retrievers.py:72-76``). Note: only the exact token ``" "`` is
    removed; multi-space tokens pass through, as in the reference."""
    words = tokenizer.cut(text)
    return [w for w in words if w not in stopwords and w != " "]


# ---------------------------------------------------------------------------
# Token counters for the splitter
# ---------------------------------------------------------------------------

_CJK_RE = re.compile(
    "[一-鿿㐀-䶿豈-﫿　-〿＀-￯]"
)
_ASCII_WORD_RE = re.compile(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]")


def approx_token_count(text: str) -> int:
    """Deterministic offline approximation of a BPE token count.

    CJK chars count 1 each; ASCII words count ceil(len/4); other punctuation
    counts 1. Whitespace is free. Stable across platforms and needs no
    downloaded vocabulary.
    """
    n = len(_CJK_RE.findall(text))
    ascii_part = _CJK_RE.sub(" ", text)
    for m in _ASCII_WORD_RE.findall(ascii_part):
        n += max(1, -(-len(m) // 4))
    return n


# Vendored cl100k BPE table (``tools/vendor_cl100k.py`` fetches it on a
# networked machine; zero-egress hosts ship the file instead of downloading).
# Overridable for tests / alternate deployments.
_CL100K_PATH_ENV = "EASYRAG_CL100K_PATH"
_VENDORED_CL100K = os.path.join(_DATA_DIR, "cl100k_base.tiktoken")

# cl100k_base construction constants (public: tiktoken_ext/openai_public.py)
_CL100K_PAT = (
    r"""'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}{1,3}"""
    r"""| ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"""
)
_CL100K_SPECIALS = {
    "<|endoftext|>": 100257,
    "<|fim_prefix|>": 100258,
    "<|fim_middle|>": 100259,
    "<|fim_suffix|>": 100260,
    "<|endofprompt|>": 100276,
}


def _load_vendored_cl100k(path: str):
    """Build the cl100k encoding from an on-disk BPE table (no network).

    The file format is the standard ``cl100k_base.tiktoken``: one
    ``<base64 token> <rank>`` pair per line.
    """
    import base64

    import tiktoken

    ranks = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return tiktoken.Encoding(
        name="cl100k_base",
        pat_str=_CL100K_PAT,
        mergeable_ranks=ranks,
        special_tokens=_CL100K_SPECIALS,
    )


_counter = None
_counter_name = None


def token_counter_info() -> str:
    """Which counter :func:`default_token_counter` selected:
    ``tiktoken-vendored`` | ``tiktoken`` | ``approx`` (or ``unselected``)."""
    return _counter_name or "unselected"


def reset_token_counter() -> None:
    """Drop the cached selection (tests / env changes)."""
    global _counter, _counter_name
    _counter = None
    _counter_name = None


def default_token_counter() -> Callable[[str], int]:
    """The splitter's token counter, resolved once per process.

    Selection order (logged, so chunk-boundary provenance is always visible —
    the counter decides chunk boundaries, PARITY deviation #2):

    1. a vendored ``cl100k_base.tiktoken`` table (``$EASYRAG_CL100K_PATH`` or
       ``easyrag_tpu_torch/data/cl100k_base.tiktoken``) — byte-identical to
       llama-index's default counter, works with zero egress;
    2. ``tiktoken.get_encoding`` — byte-identical when tiktoken's download
       cache is warm (or network exists);
    3. :func:`approx_token_count` — deterministic offline approximation
       (boundaries differ from the reference; parity comparisons must feed
       both systems the same chunk set).
    """
    global _counter, _counter_name
    if _counter is None:
        import logging

        log = logging.getLogger(__name__)
        vendored = os.environ.get(_CL100K_PATH_ENV, _VENDORED_CL100K)
        enc = None
        if os.path.exists(vendored):
            try:
                enc = _load_vendored_cl100k(vendored)
                enc.encode("warmup")
                _counter_name = "tiktoken-vendored"
            except Exception as e:  # pragma: no cover - corrupt vendor file
                log.warning("vendored cl100k at %s unusable: %s", vendored, e)
                enc = None
        if enc is None:
            try:  # pragma: no cover - depends on local tiktoken cache
                import tiktoken

                enc = tiktoken.get_encoding("cl100k_base")
                enc.encode("warmup")
                _counter_name = "tiktoken"
            except Exception:
                enc = None
        if enc is not None:
            _counter = lambda s: len(enc.encode(s, allowed_special="all"))
        else:
            _counter = approx_token_count
            _counter_name = "approx"
        log.info("splitter token counter: %s", _counter_name)
    return _counter
