"""Metadata extractors: document titles, file/knowledge paths, image objects.

Functional re-implementations of the reference's llama-index extractors
(``src/easyrag/custom/transformation.py``):

* :func:`extract_titles` — first line of each document becomes every chunk's
  ``document_title`` (``transformation.py:91-115``).
* :func:`extract_file_paths` — strips the data root from ``file_path``, sets
  ``dir`` (top-level package), ``know_path`` from ``pathmap.json``, and
  attaches OCR-filtered ``imgobjs`` from ``imgmap_filtered.json``
  (``transformation.py:37-88``).
* :func:`filter_image` — heuristics deciding which figure objects are noise
  (``transformation.py:10-34``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

from ..schema import TextNode

# sentence/keyword heuristics; True means "drop this image object"
_IGNORE_IN_TEXT = ["流程", "，", "示例", "配置", "组网图", "（可选）", "文件"]
_IGNORE_IN_TITLE = [
    "架构", "结构", "组网图", "页面", "对话框", "配置", "导读", "流程", "协议", "实例",
]
_IGNORE_IN_CONTENT = ["架构图", "树形图", "网络拓扑图", "表格"]


def filter_image(cap: str, title: str, text: str, content: str) -> bool:
    """Return True when the figure should be dropped from node metadata."""
    for word in _IGNORE_IN_TEXT:
        if f"{word}如{cap}所示" in text:
            return True
    for word in _IGNORE_IN_TITLE:
        if word in title:
            return True
    for word in _IGNORE_IN_CONTENT:
        if word in content:
            return True
    # keep only figures actually referenced in the chunk text
    if f"如{cap}所示" not in text:
        return True
    return False


def extract_titles(nodes: Sequence[TextNode]) -> None:
    """First line of each source document -> ``document_title`` on every
    chunk of that document. Relies on chunks arriving grouped by file, as
    the splitter produces them."""
    try:
        document_title = nodes[0].text.split("\n")[0]
        last_file_path = nodes[0].metadata["file_path"]
    except Exception:
        document_title = ""
        last_file_path = ""
    for node in nodes:
        if node.metadata.get("file_path") != last_file_path:
            document_title = node.text.split("\n")[0]
            last_file_path = node.metadata.get("file_path")
        node.metadata["document_title"] = document_title


def _load_json(path: str) -> Optional[Dict[str, Any]]:
    if os.path.exists(path):
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    return None


def extract_file_paths(
    nodes: Sequence[TextNode],
    data_path: str,
    pathmap: Optional[Dict[str, Any]] = None,
    imgmap: Optional[Dict[str, Any]] = None,
) -> None:
    """Normalize path metadata and attach knowledge paths + image objects.

    ``pathmap``/``imgmap`` default to ``pathmap.json`` /
    ``imgmap_filtered.json`` inside ``data_path`` when present.
    """
    if pathmap is None:
        pathmap = _load_json(os.path.join(data_path, "pathmap.json"))
    if imgmap is None:
        imgmap = _load_json(os.path.join(data_path, "imgmap_filtered.json"))
    for node in nodes:
        node.metadata["file_abs_path"] = node.metadata["file_path"]
        file_path = node.metadata["file_path"].replace(data_path + "/", "")
        node.metadata["dir"] = file_path.split("/")[0]
        node.metadata["file_path"] = file_path
        if pathmap is not None:
            node.metadata["know_path"] = "/".join(pathmap[file_path])
        if imgmap is not None and file_path in imgmap:
            imgobjs: List[Dict[str, Any]] = []
            for cap, imgobj in imgmap[file_path].items():
                if filter_image(cap, imgobj["title"], node.text, imgobj["content"]):
                    continue
                imgobj = dict(imgobj)
                imgobj["cap"] = cap
                imgobjs.append(imgobj)
            node.metadata["imgobjs"] = imgobjs


def run_extractors(nodes: Sequence[TextNode], data_path: str) -> None:
    """Apply both extractors in the reference's pipeline order
    (``src/easyrag/pipeline/ingestion.py:107-111``: title first, then paths)."""
    extract_titles(nodes)
    extract_file_paths(nodes, data_path=data_path)
