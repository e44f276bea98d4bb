"""Auto-merging retrieval over hierarchical chunks (port of
``easyrag_tpu/automerge.py``, host code).

Wraps a leaf-node retriever: when more than ``simple_ratio_thresh`` of a
parent's children are retrieved, the children are replaced by the parent
(score = mean of child scores), repeating until a fixed point, then sorting
by score. Mirrors llama-index's ``AutoMergingRetriever`` as configured at
``src/easyrag/pipeline/pipeline.py:212-217`` (thresh 0.4) over the
hierarchy from ``src/easyrag/custom/hierarchical.py``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from .schema import NodeRelationship, NodeWithScore, QueryBundle, TextNode


class AutoMergingRetriever:
    def __init__(
        self,
        base_retriever,
        all_nodes: List[TextNode],
        simple_ratio_thresh: float = 0.5,
    ) -> None:
        self._base = base_retriever
        self._by_id: Dict[str, TextNode] = {n.node_id: n for n in all_nodes}
        self._thresh = simple_ratio_thresh

    # expose the wrapped retriever's filter knob (pipeline sets it)
    @property
    def filter_dict(self):
        return self._base.filter_dict

    @filter_dict.setter
    def filter_dict(self, value):
        self._base.filter_dict = value

    def _merge_once(self, nodes: List[NodeWithScore]) -> Tuple[List[NodeWithScore], bool]:
        children_of: Dict[str, List[NodeWithScore]] = defaultdict(list)
        for nws in nodes:
            parent_id = nws.node.relationships.get(NodeRelationship.PARENT)
            if parent_id is not None and parent_id in self._by_id:
                children_of[parent_id].append(nws)
        to_delete = set()
        to_add: Dict[str, NodeWithScore] = {}
        for parent_id, retrieved in children_of.items():
            parent = self._by_id[parent_id]
            total = len(parent.relationships.get(NodeRelationship.CHILD, [])) or 1
            if len(retrieved) / total > self._thresh:
                to_delete.update(c.node.node_id for c in retrieved)
                avg = sum((c.score or 0.0) for c in retrieved) / len(retrieved)
                to_add[parent_id] = NodeWithScore(node=parent, score=avg)
        if not to_add:
            return nodes, False
        merged = [n for n in nodes if n.node.node_id not in to_delete]
        merged.extend(to_add.values())
        return merged, True

    def retrieve(self, query_bundle: QueryBundle) -> List[NodeWithScore]:
        nodes = self._base.retrieve(query_bundle)
        nodes, changed = self._merge_once(nodes)
        while changed:
            nodes, changed = self._merge_once(nodes)
        return sorted(nodes, key=lambda n: n.score or 0.0, reverse=True)

    async def aretrieve(self, query_bundle: QueryBundle) -> List[NodeWithScore]:
        return self.retrieve(query_bundle)
