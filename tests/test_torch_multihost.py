"""The port's multi-host index build (``easyrag_tpu_torch/parallel/multihost.py``):
the analogues of ``tests/test_multihost.py``.

The shard/assemble flow with "hosts" run one after another, the assembled
retrieval equal to a single-host build, the shard artifacts read alike by
both packages, and two real processes joined by ``torch.distributed`` over
gloo exchanging ragged shards of embeddings. The two workers run this file
as a script (``python test_torch_multihost.py <pid> <nproc> <port>
<out_dir>``), which imports nothing of JAX.
"""

import os
import socket
import subprocess
import sys
import zlib

import numpy as np

from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
from easyrag_tpu_torch.parallel.multihost import (
    allgather_shard_embeddings,
    assemble_shards,
    build_shard,
    init_distributed,
    shard_documents,
)
from easyrag_tpu_torch.schema import Document

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = [
    "扩容指南\nCDU虚机每次扩容的最大SC个数为15。",
    "备份说明\n系统支持全量备份和增量备份。",
    "鉴权配置\n鉴权失败时检查LDAP连接。",
    "升级说明\n升级前需要备份配置文件。",
    "巡检手册\n每日巡检需要检查虚机状态。",
]


def _docs():
    return [Document(text=t, metadata={"file_path": f"d/{i}.txt"}) for i, t in enumerate(TEXTS)]


def _parse(docs):
    return SentenceSplitter(chunk_size=64, chunk_overlap=0, token_counter=len).parse_documents(docs)


def _embed(nodes):
    """A per-text embedding that every process computes alike (the builtin
    ``hash`` is salted per process)."""
    return np.stack([np.full(8, (zlib.crc32(n.text.encode("utf-8")) % 1000) / 1000.0, np.float32) for n in nodes])


def test_allgather_single_process_identity():
    from easyrag_tpu.parallel.multihost import allgather_shard_embeddings as jax_allgather

    emb = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(allgather_shard_embeddings(emb), emb)
    np.testing.assert_array_equal(allgather_shard_embeddings(emb), jax_allgather(emb))
    init_distributed(num_processes=1)  # a single process joins no group


def test_shard_documents_partition():
    from easyrag_tpu.parallel.multihost import shard_documents as jax_shard_documents

    docs = list(range(10))
    shards = [shard_documents(docs, p, 3) for p in range(3)]
    assert sorted(x for s in shards for x in s) == docs
    assert shards[0] == [0, 3, 6, 9]
    assert shards == [jax_shard_documents(docs, p, 3) for p in range(3)]


def test_multihost_build_matches_single_host(tmp_path):
    from easyrag_tpu.parallel.multihost import assemble_shards as jax_assemble
    from easyrag_tpu_torch.corpus.tokenizer import JiebaTokenizer, default_stopwords
    from easyrag_tpu_torch.retrievers import BM25Retriever
    from easyrag_tpu_torch.schema import QueryBundle

    out = str(tmp_path / "shards")
    for pid in range(3):  # three hosts, one after another
        build_shard(_docs(), pid, 3, _parse, out, embed_fn=_embed)
    nodes, emb = assemble_shards(out)
    assert emb is not None and len(emb) == len(nodes)
    direct = [n for pid in range(3) for n in _parse(shard_documents(_docs(), pid, 3))]  # process order
    assert [n.text for n in nodes] == [n.text for n in direct]
    np.testing.assert_array_equal(emb, _embed(direct))
    # the JAX package assembles the port's shard artifacts alike
    jnodes, jemb = jax_assemble(out)
    assert [n.text for n in jnodes] == [n.text for n in nodes]
    assert [n.metadata for n in jnodes] == [n.metadata for n in nodes]
    np.testing.assert_array_equal(jemb, emb)

    tk, sw = JiebaTokenizer(), default_stopwords()
    q = QueryBundle(query_str="备份配置文件")
    got = [(n.node.text, n.score) for n in BM25Retriever(nodes, tk, sw, similarity_top_k=3, device="cpu").retrieve(q)]
    want = [(n.node.text, n.score) for n in BM25Retriever(direct, tk, sw, similarity_top_k=3, device="cpu").retrieve(q)]
    assert got == want and got


def test_two_process_gloo_allgather(tmp_path):
    """Two OS processes join a gloo group on a local port and run the count
    exchange and the padded all-gather of ``allgather_shard_embeddings``:
    both end with the same matrix, equal to the shard artifacts assembled in
    process order, from shards of different sizes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "shards"
    out.mkdir()
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), "2", str(port), str(out)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    nodes, assembled = assemble_shards(str(out))
    assert assembled is not None and len(assembled) == len(nodes)
    g0, g1 = np.load(out / "gathered_0.npy"), np.load(out / "gathered_1.npy")
    np.testing.assert_array_equal(g0, g1)
    np.testing.assert_array_equal(g0, assembled)
    sizes = {len(np.load(out / d / "emb.npy")) for d in os.listdir(out) if d.startswith("shard_")}
    assert len(sizes) > 1, sizes  # ragged: the padding path ran


def worker(pid: int, nproc: int, port: str, out_dir: str) -> None:
    """One "host" of the two-process test: join the group, build and save
    its shard, all-gather the embeddings, save what came back."""
    import torch.distributed as dist

    init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
    assert dist.get_world_size() == nproc
    nodes = build_shard(_docs(), pid, nproc, _parse, out_dir, embed_fn=_embed)
    np.save(os.path.join(out_dir, f"gathered_{pid}.npy"), allgather_shard_embeddings(_embed(nodes)))
    dist.destroy_process_group()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
