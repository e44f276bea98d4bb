"""Chinese-aware sentence splitter and node parser.

Re-implements the chunking semantics of the reference's forked llama-index
``SentenceSplitter`` (``src/easyrag/custom/splitter.py``):

* recursive split cascade: paragraph separator ``"\\n\\n\\n"`` → nltk punkt
  sentence spans → Chinese secondary regex ``"[^,.;。？！]+[,.;。？！]?"`` →
  space → char (``splitter.py:93-102,191-223``)
* greedy merge to ``chunk_size`` tokens with sentence-boundary-preserving
  overlap rebuilt from the tail of the previous chunk
  (``splitter.py:225-287``)
* metadata-aware entry point measures metadata then ignores it — a reference
  quirk kept for parity (``splitter.py:149-167`` computes ``metadata_len``
  but sets ``effective_chunk_size = self.chunk_size``).

Node parsing (documents → :class:`TextNode` with SOURCE/PREVIOUS/NEXT
relationships) replaces the llama-index ``MetadataAwareTextSplitter`` base.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from ..schema import Document, NodeRelationship, TextNode
from .tokenizer import default_token_counter

CHUNKING_REGEX = "[^,.;。？！]+[,.;。？！]?"
PARAGRAPH_SEP = "\n\n\n"


@dataclass
class _Piece:
    text: str
    is_sentence: bool
    token_size: int


def split_keep_sep(text: str, sep: str) -> List[str]:
    """Split on ``sep`` keeping the separator prepended to trailing parts
    and dropping empties (llama-index ``split_text_keep_separator``)."""
    parts = text.split(sep)
    out = [(sep + p if i > 0 else p) for i, p in enumerate(parts)]
    return [p for p in out if p]


def punkt_sentence_split() -> Callable[[str], List[str]]:
    """nltk punkt span tokenizer, each sentence extended to the start of the
    next span so inter-sentence whitespace is preserved (llama-index
    ``split_by_sentence_tokenizer`` semantics)."""
    import nltk

    tokenizer = nltk.tokenize.PunktSentenceTokenizer()

    def split(text: str) -> List[str]:
        spans = list(tokenizer.span_tokenize(text))
        sentences = []
        for i, span in enumerate(spans):
            start = span[0]
            end = spans[i + 1][0] if i < len(spans) - 1 else len(text)
            sentences.append(text[start:end])
        return sentences

    return split


class SentenceSplitter:
    def __init__(
        self,
        chunk_size: int = 1024,
        chunk_overlap: int = 200,
        separator: str = " ",
        paragraph_separator: str = PARAGRAPH_SEP,
        secondary_chunking_regex: str = CHUNKING_REGEX,
        token_counter: Optional[Callable[[str], int]] = None,
        sentence_splitter: Optional[Callable[[str], List[str]]] = None,
        include_prev_next_rel: bool = True,
    ) -> None:
        if chunk_overlap > chunk_size:
            raise ValueError(
                f"chunk_overlap ({chunk_overlap}) > chunk_size ({chunk_size})"
            )
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.include_prev_next_rel = include_prev_next_rel
        self._count = token_counter or default_token_counter()
        sentence_fn = sentence_splitter or punkt_sentence_split()
        regex = re.compile(secondary_chunking_regex)
        # primary fns mark results as full sentences; sub-sentence fns don't
        self._split_fns: List[Callable[[str], List[str]]] = [
            lambda t: split_keep_sep(t, paragraph_separator),
            sentence_fn,
        ]
        self._sub_split_fns: List[Callable[[str], List[str]]] = [
            lambda t: regex.findall(t),
            lambda t: split_keep_sep(t, separator),
            list,
        ]

    # -- text → chunks ------------------------------------------------------

    def split_text(self, text: str) -> List[str]:
        return self._split_text(text, self.chunk_size)

    def split_text_metadata_aware(self, text: str, metadata_str: str) -> List[str]:
        # parity quirk: metadata length measured but not subtracted
        _ = self._count(metadata_str)
        return self._split_text(text, self.chunk_size)

    def _split_text(self, text: str, chunk_size: int) -> List[str]:
        if text == "":
            return [text]
        pieces = self._split(text, chunk_size)
        return self._merge(pieces, chunk_size)

    def _first_splitting(self, text: str) -> Tuple[List[str], bool]:
        """First cascade level that yields >1 part; primary levels flag the
        parts as complete sentences (``splitter.py:304-315``)."""
        for fn in self._split_fns:
            parts = fn(text)
            if len(parts) > 1:
                return parts, True
        parts = [text]
        for fn in self._sub_split_fns:
            parts = fn(text)
            if len(parts) > 1:
                break
        return parts, False

    def _split(self, text: str, chunk_size: int) -> List[_Piece]:
        size = self._count(text)
        if size <= chunk_size:
            return [_Piece(text, is_sentence=True, token_size=size)]
        parts, is_sentence = self._first_splitting(text)
        pieces: List[_Piece] = []
        for part in parts:
            part_size = self._count(part)
            if part_size <= chunk_size:
                pieces.append(_Piece(part, is_sentence, part_size))
            else:
                pieces.extend(self._split(part, chunk_size))
        return pieces

    def _merge(self, pieces: List[_Piece], chunk_size: int) -> List[str]:
        """Greedy accumulation with overlap rebuilt from the previous chunk's
        tail pieces (``splitter.py:225-287``). Uses an explicit cursor rather
        than the reference's O(n^2) ``list.pop(0)`` loop; the visit order and
        decisions are identical."""
        chunks: List[str] = []
        cur: List[Tuple[str, int]] = []
        cur_len = 0
        fresh = True  # current chunk has no payload yet (overlap aside)

        def close_chunk() -> None:
            nonlocal cur, cur_len, fresh
            chunks.append("".join(t for t, _ in cur))
            last = cur
            cur, cur_len, fresh = [], 0, True
            # seed next chunk with as many tail pieces as fit in the overlap
            i = len(last) - 1
            while i >= 0 and cur_len + last[i][1] <= self.chunk_overlap:
                text, length = last[i]
                cur_len += length
                cur.insert(0, (text, length))
                i -= 1

        pos = 0
        while pos < len(pieces):
            piece = pieces[pos]
            if piece.token_size > chunk_size:
                raise ValueError("Single token exceeded chunk size")
            if cur_len + piece.token_size > chunk_size and not fresh:
                close_chunk()
            else:
                if (
                    piece.is_sentence
                    or cur_len + piece.token_size <= chunk_size
                    or fresh
                ):
                    cur_len += piece.token_size
                    cur.append((piece.text, piece.token_size))
                    pos += 1
                    fresh = False
                else:
                    close_chunk()

        if not fresh:
            chunks.append("".join(t for t, _ in cur))

        return [c.strip() for c in chunks if c.strip() != ""]

    # -- documents → nodes --------------------------------------------------

    def parse_documents(self, documents: Sequence[Document]) -> List[TextNode]:
        """Split every document and wire SOURCE + PREVIOUS/NEXT relationships
        between adjacent chunks of the same document."""
        nodes: List[TextNode] = []
        for doc in documents:
            chunks = self.split_text_metadata_aware(
                doc.text, metadata_str=str(doc.metadata)
            )
            doc_nodes = [
                TextNode(
                    text=chunk,
                    metadata=dict(doc.metadata),
                    relationships={NodeRelationship.SOURCE: doc.doc_id},
                )
                for chunk in chunks
            ]
            if self.include_prev_next_rel:
                for i, node in enumerate(doc_nodes):
                    if i > 0:
                        node.relationships[NodeRelationship.PREVIOUS] = doc_nodes[
                            i - 1
                        ].node_id
                    if i < len(doc_nodes) - 1:
                        node.relationships[NodeRelationship.NEXT] = doc_nodes[
                            i + 1
                        ].node_id
            nodes.extend(doc_nodes)
        return nodes
