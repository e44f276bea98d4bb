"""Core document/node data model.

A deliberately small, array-friendly replacement for the llama-index object
graph the reference builds on (``llama_index.core.schema``). Nodes carry only
what the EasyRAG pipeline actually uses: text, metadata, prev/next +
parent/child relationships, and a score wrapper.

Reference behavior being mirrored:
  * ``node.get_content()`` returns the raw chunk text
    (fusion dedup keys on it — ``src/easyrag/custom/retrievers.py:246``).
  * prev/next relationships drive the ``embed_type=6`` table-header walk
    (``src/easyrag/pipeline/ingestion.py:36-55``).
  * parent/child relationships drive hierarchical auto-merging
    (``src/easyrag/custom/hierarchical.py``).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional


class NodeRelationship(str, Enum):
    SOURCE = "source"
    PREVIOUS = "previous"
    NEXT = "next"
    PARENT = "parent"
    CHILD = "child"


def _new_id() -> str:
    return str(uuid.uuid4())


@dataclass
class Document:
    """A source document (one ``.txt`` file of the corpus)."""

    text: str
    metadata: Dict[str, Any] = field(default_factory=dict)
    doc_id: str = field(default_factory=_new_id)

    def get_content(self) -> str:
        return self.text


@dataclass
class TextNode:
    """A chunk of a document, plus metadata and graph relationships.

    ``relationships`` maps a :class:`NodeRelationship` to a node id (or a
    list of node ids for CHILD).
    """

    text: str
    metadata: Dict[str, Any] = field(default_factory=dict)
    node_id: str = field(default_factory=_new_id)
    relationships: Dict[NodeRelationship, Any] = field(default_factory=dict)
    # index of this node in its corpus ordering; set by the corpus builder so
    # device kernels can address nodes by dense integer id.
    idx: int = -1

    def get_content(self) -> str:
        return self.text

    def prev_id(self) -> Optional[str]:
        return self.relationships.get(NodeRelationship.PREVIOUS)

    def next_id(self) -> Optional[str]:
        return self.relationships.get(NodeRelationship.NEXT)

    def parent_id(self) -> Optional[str]:
        return self.relationships.get(NodeRelationship.PARENT)

    def child_ids(self) -> List[str]:
        return list(self.relationships.get(NodeRelationship.CHILD, []))


@dataclass
class NodeWithScore:
    """A retrieved node and its retrieval score."""

    node: TextNode
    score: Optional[float] = None

    def get_content(self) -> str:
        return self.node.get_content()

    @property
    def metadata(self) -> Dict[str, Any]:
        return self.node.metadata

    @property
    def text(self) -> str:
        return self.node.text


@dataclass
class QueryBundle:
    """Query container (mirrors llama-index ``QueryBundle`` usage).

    ``custom_embedding_strs`` carries HyDE pseudo-documents, matching
    ``HyDEQueryTransform`` output consumed at
    ``src/easyrag/pipeline/pipeline.py:330``.
    """

    query_str: str
    custom_embedding_strs: Optional[List[str]] = None
    embedding: Optional[List[float]] = None


def build_nodeid2idx(nodes: List[TextNode]) -> Dict[str, int]:
    """Node-id -> list-index map (``src/easyrag/pipeline/pipeline.py:220-223``)."""
    out: Dict[str, int] = {}
    for i, node in enumerate(nodes):
        out[node.node_id] = i
        node.idx = i
    return out
