"""Multi-host index build (port of ``easyrag_tpu/parallel/multihost.py``).

Shard artifacts, then assemble:

1. every host parses (and embeds) its round-robin share of the documents
   (:func:`build_shard`) and writes a shard artifact (``nodes.jsonl`` and
   ``emb.npy``) to a shared directory;
2. one host, or a later boot, assembles the shards in process order into
   the corpus state (:func:`assemble_shards`): the global node order is the
   processes' order, and the sparse index is built over the assembled nodes
   (BM25's IDF is corpus-wide, so postings cannot be finished per shard).

Instead of a shared directory the hosts may exchange their embeddings with
:func:`allgather_shard_embeddings`, a ``torch.distributed`` all-gather over
gloo (host tensors: the embeddings are numpy) after
:func:`init_distributed`. With one process everything runs locally.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..index.artifact import load_nodes, save_nodes
from ..schema import TextNode


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the gloo process group at ``coordinator_address`` (``host:port``;
    process 0 listens there) as ``process_id`` of ``num_processes``; nothing
    for a single process. Nothing tells a process of a cluster: the caller
    gives all three."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id
    )


def shard_documents(documents: Sequence, process_id: int, num_processes: int) -> List:
    """Deterministic round-robin document partition (order-stable)."""
    return [doc for i, doc in enumerate(documents) if i % num_processes == process_id]


def build_shard(
    documents: Sequence,
    process_id: int,
    num_processes: int,
    parse_fn: Callable[[Sequence], List[TextNode]],
    out_dir: str,
    embed_fn: Optional[Callable[[List[TextNode]], np.ndarray]] = None,
) -> List[TextNode]:
    """Parse (and optionally embed) this host's share of the documents and
    save it as ``<out_dir>/shard_<pid>``; returns the shard's nodes."""
    nodes = parse_fn(shard_documents(documents, process_id, num_processes))
    shard_dir = os.path.join(out_dir, f"shard_{process_id:05d}")
    os.makedirs(shard_dir, exist_ok=True)
    save_nodes(nodes, os.path.join(shard_dir, "nodes.jsonl"))
    if embed_fn is not None:
        np.save(os.path.join(shard_dir, "emb.npy"), np.asarray(embed_fn(nodes), dtype=np.float32))
    return nodes


def allgather_shard_embeddings(local_emb: np.ndarray) -> np.ndarray:
    """Every process's shard embeddings, in process order (the order
    :func:`assemble_shards` defines); processes call it together. Shards
    differ in size (chunking depends on the text), so the row counts are
    exchanged first and each shard is padded to the largest before the
    gather, then trimmed. The identity without a process group or with one
    process."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return np.asarray(local_emb)
    world = dist.get_world_size()
    local = torch.from_numpy(np.ascontiguousarray(local_emb, dtype=np.float32))
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([local.shape[0]], dtype=torch.int64))
    counts = [int(c) for c in counts]
    padded = torch.zeros((max(counts), local.shape[1]), dtype=torch.float32)
    padded[: local.shape[0]] = local
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded)
    return torch.cat([g[:n] for g, n in zip(gathered, counts)]).numpy()


def assemble_shards(out_dir: str) -> Tuple[List[TextNode], Optional[np.ndarray]]:
    """Every shard artifact under ``out_dir``, in process order, as the
    global node list and, where every shard has one, the embedding matrix
    aligned with it."""
    shard_dirs = sorted(d for d in os.listdir(out_dir) if d.startswith("shard_"))
    if not shard_dirs:
        raise FileNotFoundError(f"no shard_* dirs under {out_dir}")
    nodes: List[TextNode] = []
    embs: List[np.ndarray] = []
    have_emb = True
    for d in shard_dirs:
        shard = os.path.join(out_dir, d)
        shard_nodes = load_nodes(os.path.join(shard, "nodes.jsonl"))
        nodes.extend(shard_nodes)
        emb_path = os.path.join(shard, "emb.npy")
        if os.path.exists(emb_path):
            emb = np.load(emb_path)
            if len(emb) != len(shard_nodes):
                raise ValueError(f"{d}: {len(emb)} embeddings vs {len(shard_nodes)} nodes")
            embs.append(emb)
        else:
            have_emb = False
    return nodes, np.concatenate(embs) if (have_emb and embs) else None
