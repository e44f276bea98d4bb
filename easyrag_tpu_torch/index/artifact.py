"""On-disk corpus artifact (port of ``easyrag_tpu/index/artifact.py``), the
qdrant-collection analog, in the same format, so an artifact saved by either
package loads in the other:

  nodes.jsonl          text + metadata + relationships per node
  all_nodes.jsonl      every node of a hierarchical split (parents too)
  sparse_content/      packed BM25 index over the content view
  sparse_path/         packed BM25 index over the know-path view
  manifest.json        config fingerprint for cache invalidation

Boot becomes a load instead of re-chunk + re-tokenize + re-index. The dense
route keeps its own artifact (``index/dense.py``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..schema import NodeRelationship, TextNode
from .sparse import SparseIndex, load_sparse_index, save_sparse_index

MANIFEST = "manifest.json"


def save_nodes(nodes: List[TextNode], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for node in nodes:
            rel = {k.value: v for k, v in node.relationships.items()}
            f.write(
                json.dumps(
                    {
                        "id": node.node_id,
                        "text": node.text,
                        "metadata": node.metadata,
                        "relationships": rel,
                    },
                    ensure_ascii=False,
                )
                + "\n"
            )


def load_nodes(path: str) -> List[TextNode]:
    nodes: List[TextNode] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            row = json.loads(line)
            nodes.append(
                TextNode(
                    text=row["text"],
                    metadata=row["metadata"],
                    node_id=row["id"],
                    relationships={
                        NodeRelationship(k): v
                        for k, v in row["relationships"].items()
                    },
                )
            )
    return nodes


class CorpusArtifact:
    def __init__(self, root: str) -> None:
        self.root = root

    def exists(self) -> bool:
        return os.path.exists(os.path.join(self.root, MANIFEST))

    def manifest(self) -> Dict:
        with open(os.path.join(self.root, MANIFEST), encoding="utf-8") as f:
            return json.load(f)

    def save(
        self,
        nodes: List[TextNode],
        fingerprint: Dict,
        sparse_content: Optional[SparseIndex] = None,
        sparse_path: Optional[SparseIndex] = None,
        all_nodes: Optional[List[TextNode]] = None,
    ) -> None:
        os.makedirs(self.root, exist_ok=True)
        save_nodes(nodes, os.path.join(self.root, "nodes.jsonl"))
        if all_nodes is not None and all_nodes is not nodes:
            save_nodes(all_nodes, os.path.join(self.root, "all_nodes.jsonl"))
        if sparse_content is not None:
            save_sparse_index(sparse_content, os.path.join(self.root, "sparse_content"))
        if sparse_path is not None:
            save_sparse_index(sparse_path, os.path.join(self.root, "sparse_path"))
        with open(os.path.join(self.root, MANIFEST), "w", encoding="utf-8") as f:
            json.dump(
                {
                    "fingerprint": fingerprint,
                    "num_nodes": len(nodes),
                    "has_sparse_content": sparse_content is not None,
                    "has_sparse_path": sparse_path is not None,
                    "has_all_nodes": all_nodes is not None and all_nodes is not nodes,
                },
                f,
                ensure_ascii=False,
            )

    def load_nodes(self) -> List[TextNode]:
        return load_nodes(os.path.join(self.root, "nodes.jsonl"))

    def load_all_nodes(self) -> Optional[List[TextNode]]:
        path = os.path.join(self.root, "all_nodes.jsonl")
        return load_nodes(path) if os.path.exists(path) else None

    def load_sparse(self, which: str) -> Optional[SparseIndex]:
        path = os.path.join(self.root, f"sparse_{which}")
        if os.path.exists(os.path.join(path, "sparse_meta.json")):
            return load_sparse_index(path)
        return None

    def matches(self, fingerprint: Dict) -> bool:
        return self.exists() and self.manifest().get("fingerprint") == fingerprint
