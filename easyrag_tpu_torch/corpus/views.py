"""Node content views — the ``embed_type`` contract.

Every stage of the pipeline (dense embedding, BM25 corpus build, reranking,
final LLM context) renders nodes through one view function with a different
integer ``embed_type``. This mirrors ``get_node_content`` at
``src/easyrag/pipeline/ingestion.py:34-76`` exactly:

====== ==========================================================
type   view
====== ==========================================================
0      raw chunk text
1      ``###\\n<file_path>\\n\\n<text>``
2      ``###\\n<know_path>\\n\\n<text>``
3      text with figure captions enriched by OCR content
4      file_path only ("" if missing)
5      know_path only ("" if missing)
6      OCR enrichment (as 3) + table-header recovery via a walk over
       PREVIOUS relationships, merging chunks with overlap dedup
====== ==========================================================
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

from ..schema import NodeRelationship, NodeWithScore, TextNode


def merge_strings(a: str, b: str) -> str:
    """Concatenate ``a`` and ``b`` dropping the longest overlap where the end
    of ``a`` equals the start of ``b`` (``ingestion.py:20-31``)."""
    max_overlap = 0
    min_length = min(len(a), len(b))
    for i in range(1, min_length + 1):
        if a[-i:] == b[:i]:
            max_overlap = i
    return a + b[max_overlap:]


def _recover_table_header(
    node: TextNode,
    text: str,
    nodes: List[TextNode],
    nodeid2idx: Dict[str, int],
) -> str:
    """Markdown-table chunks that lost their header row (they contain many
    ``|`` but no ``---`` separator) walk back through PREVIOUS chunks until a
    chunk holding the separator row is found (up to 3 hops), then stitch the
    header line + separator back on (``ingestion.py:36-55``)."""
    cur_text = text
    if not (cur_text.count("|") >= 5 and cur_text.count("---") == 0):
        return text
    cnt = 0
    flag = False
    while True:
        # Parity quirk: the reference loop never advances past the immediate
        # PREVIOUS node (``node`` is not reassigned in ``ingestion.py:41-51``),
        # so iterations 2..3 re-merge the same text as no-ops and the header
        # is only recovered when the *direct* predecessor holds the separator
        # row. Replicated faithfully; do not "fix" without updating the
        # golden-parity tests.
        pre_node_id = node.relationships[NodeRelationship.PREVIOUS]
        pre_node = nodes[nodeid2idx[pre_node_id]]
        pre_text = pre_node.text
        cur_text = merge_strings(pre_text, cur_text)
        cnt += 1
        if pre_text.count("---") >= 2:
            flag = True
            break
        if cnt >= 3:
            break
    if flag:
        idx = cur_text.index("---")
        return cur_text[:idx].strip().split("\n")[-1] + cur_text[idx:]
    return text


def _enrich_with_ocr(node: TextNode, text: str) -> str:
    """Replace ``"<cap> <title>\\n"`` figure stubs with
    ``"<cap>.<title>:<ocr content>\\n"`` (``ingestion.py:62-65``)."""
    imgobjs = node.metadata.get("imgobjs")
    if imgobjs:
        for imgobj in imgobjs:
            text = text.replace(
                f"{imgobj['cap']} {imgobj['title']}\n",
                f"{imgobj['cap']}.{imgobj['title']}:{imgobj['content']}\n",
            )
    return text


def get_node_content(
    node: Union[TextNode, NodeWithScore],
    embed_type: int = 0,
    nodes: Optional[List[TextNode]] = None,
    nodeid2idx: Optional[Dict[str, int]] = None,
) -> str:
    """Render a node through the given ``embed_type`` view (see module doc).

    Accepts either a bare :class:`TextNode` or a :class:`NodeWithScore`, as
    the reference is called with both.
    """
    inner = node.node if isinstance(node, NodeWithScore) else node
    text = inner.get_content()

    if embed_type == 6:
        text = _recover_table_header(inner, text, nodes, nodeid2idx)

    # NOTE: the reference dispatches type 6 through both the table walk above
    # and the OCR enrichment below (``elif embed_type == 3 or embed_type == 6``).
    if embed_type == 1:
        if "file_path" in inner.metadata:
            text = "###\n" + inner.metadata["file_path"] + "\n\n" + text
    elif embed_type == 2:
        if "know_path" in inner.metadata:
            text = "###\n" + inner.metadata["know_path"] + "\n\n" + text
    elif embed_type == 3 or embed_type == 6:
        text = _enrich_with_ocr(inner, text)
    elif embed_type == 4:
        text = inner.metadata.get("file_path", "")
    elif embed_type == 5:
        text = inner.metadata.get("know_path", "")
    return text
