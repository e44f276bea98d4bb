"""HTML -> markdown-ish text conversion (port of ``easyrag_tpu/corpus/html_text.py``).

Stands in for the reference's html2text usage (``src/preprocess_zedx.py:69-76``
with ``ignore_links/ignore_images/body_width=0``) with BeautifulSoup
(``bs4``, imported where it is used); html2text is not a dependency.
Structure the downstream pipeline depends on is preserved:

* tables become pipe rows with a ``| --- |`` separator row — the
  ``embed_type=6`` table-header recovery keys on those markers
  (``src/easyrag/pipeline/ingestion.py:36-55``)
* headings -> ``#``-prefixed lines, list items -> ``* `` / ``1. ``
* links/images dropped, no line wrapping
"""

from __future__ import annotations

from typing import List

_BLOCK_TAGS = {
    "p", "div", "section", "article", "blockquote", "figure", "figcaption",
    "table", "ul", "ol", "li", "tr", "pre", "h1", "h2", "h3", "h4", "h5", "h6",
}


def _render_table(table) -> str:
    rows: List[List[str]] = []
    for tr in table.find_all("tr"):
        cells = tr.find_all(["th", "td"])
        rows.append([" ".join(c.get_text(" ", strip=True).split()) for c in cells])
    if not rows:
        return ""
    width = max(len(r) for r in rows)
    rows = [r + [""] * (width - len(r)) for r in rows]
    out = ["| " + " | ".join(rows[0]) + " |"]
    out.append("| " + " | ".join(["---"] * width) + " |")
    for r in rows[1:]:
        out.append("| " + " | ".join(r) + " |")
    return "\n".join(out)


def _render(node, out: List[str]) -> None:
    from bs4 import NavigableString, Tag

    if isinstance(node, NavigableString):
        text = str(node)
        if text.strip():
            out.append(" ".join(text.split()))
        return
    if not isinstance(node, Tag):
        return
    name = node.name.lower()
    if name in ("script", "style", "img", "a") and name != "a":
        return
    if name == "a":  # keep anchor text, drop the link
        text = node.get_text(" ", strip=True)
        if text:
            out.append(" ".join(text.split()))
        return
    if name == "br":
        out.append("\n")
        return
    if name == "table":
        out.append("\n\n" + _render_table(node) + "\n\n")
        return
    if name.startswith("h") and len(name) == 2 and name[1].isdigit():
        level = int(name[1])
        out.append("\n\n" + "#" * level + " " + node.get_text(" ", strip=True) + "\n\n")
        return
    if name == "li":
        inner: List[str] = []
        for child in node.children:
            _render(child, inner)
        out.append("\n* " + " ".join(x for x in inner if x != "\n").strip())
        return
    if name == "pre":
        out.append("\n\n" + node.get_text() + "\n\n")
        return
    is_block = name in _BLOCK_TAGS
    if is_block:
        out.append("\n\n")
    for child in node.children:
        _render(child, out)
    if is_block:
        out.append("\n\n")


def html_to_text(html: str) -> str:
    from bs4 import BeautifulSoup

    soup = BeautifulSoup(html, "html.parser")
    for tag in soup.find_all(["script", "style"]):
        tag.decompose()
    pieces: List[str] = []
    _render(soup, pieces)
    # join inline runs with spaces, collapse blank-line runs
    text = ""
    for piece in pieces:
        if piece.startswith("\n") or piece.endswith("\n"):
            text += piece
        else:
            if text and not text.endswith(("\n", " ")):
                text += " "
            text += piece
    lines = [ln.rstrip() for ln in text.split("\n")]
    out_lines: List[str] = []
    blank = False
    for ln in lines:
        if ln.strip() == "":
            if not blank and out_lines:
                out_lines.append("")
            blank = True
        else:
            out_lines.append(ln)
            blank = False
    return "\n".join(out_lines).strip() + "\n"
