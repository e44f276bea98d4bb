"""Hierarchical (multi-level) chunking with parent/child relationships (port
of ``easyrag_tpu/corpus/hierarchical.py``, host code).

Mirrors the reference's forked llama-index ``HierarchicalNodeParser``
(``src/easyrag/custom/hierarchical.py``): each level re-chunks the previous
level's nodes with a smaller chunk size; sub-nodes of level > 0 get
PARENT/CHILD links; the flat result is ordered per document as
``[level-0 nodes..., level-1 nodes..., ...]`` (``hierarchical.py:160-234``).

The pipeline uses ``chunk_sizes=[chunk_size*4, chunk_size]``
(``src/easyrag/pipeline/ingestion.py:103-106``) and retrieves over
:func:`get_leaf_nodes` with auto-merging (``pipeline.py:180-217``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..schema import Document, NodeRelationship, TextNode
from .splitter import SentenceSplitter


def _link_parent_child(parent: TextNode, child: TextNode) -> None:
    children = parent.relationships.setdefault(NodeRelationship.CHILD, [])
    children.append(child.node_id)
    child.relationships[NodeRelationship.PARENT] = parent.node_id


def get_leaf_nodes(nodes: List[TextNode]) -> List[TextNode]:
    return [n for n in nodes if NodeRelationship.CHILD not in n.relationships]


def get_root_nodes(nodes: List[TextNode]) -> List[TextNode]:
    return [n for n in nodes if NodeRelationship.PARENT not in n.relationships]


def get_child_nodes(nodes: List[TextNode], all_nodes: List[TextNode]) -> List[TextNode]:
    child_ids = set()
    for node in nodes:
        child_ids.update(node.relationships.get(NodeRelationship.CHILD, []))
    return [n for n in all_nodes if n.node_id in child_ids]


def get_deeper_nodes(nodes: List[TextNode], depth: int = 1) -> List[TextNode]:
    if depth < 0:
        raise ValueError("Depth cannot be a negative number!")
    roots = get_root_nodes(nodes)
    if not roots:
        raise ValueError("There is no root nodes in given nodes!")
    deeper = roots
    for _ in range(depth):
        deeper = get_child_nodes(deeper, nodes)
    return deeper


class HierarchicalSplitter:
    def __init__(
        self,
        chunk_sizes: Optional[List[int]] = None,
        chunk_overlap: int = 20,
        splitters: Optional[List[SentenceSplitter]] = None,
    ) -> None:
        if splitters is None:
            chunk_sizes = chunk_sizes or [2048, 512, 128]
            splitters = [
                SentenceSplitter(chunk_size=size, chunk_overlap=chunk_overlap)
                for size in chunk_sizes
            ]
        self.chunk_sizes = chunk_sizes
        self.splitters = splitters

    def _parse_level(self, parents: List[TextNode], level: int) -> List[TextNode]:
        """Split each node of ``parents`` with the level's splitter; link
        parent/child for level > 0; recurse one level deeper."""
        sub_nodes: List[TextNode] = []
        for parent in parents:
            as_doc = Document(
                text=parent.text, metadata=dict(parent.metadata), doc_id=parent.node_id
            )
            children = self.splitters[level].parse_documents([as_doc])
            if level > 0:
                for child in children:
                    _link_parent_child(parent, child)
            sub_nodes.extend(children)
        if level < len(self.splitters) - 1:
            deeper = self._parse_level(sub_nodes, level + 1)
        else:
            deeper = []
        return sub_nodes + deeper

    def parse_documents(self, documents: Sequence[Document]) -> List[TextNode]:
        all_nodes: List[TextNode] = []
        for doc in documents:
            root = TextNode(
                text=doc.text, metadata=dict(doc.metadata), node_id=doc.doc_id
            )
            all_nodes.extend(self._parse_level([root], 0))
        return all_nodes
