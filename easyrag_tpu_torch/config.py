"""Typed configuration with the reference's full knob surface.

The reference reads a single YAML into an untyped dict
(``src/easyrag/utils/__init__.py:4-9``) keyed throughout
``src/easyrag/pipeline/pipeline.py``. Here the same knobs (same names, same
integer encodings, same defaults as ``src/configs/easyrag.yaml``) become a
validated dataclass, plus a ``tpu`` section for execution choices that
have no reference counterpart (named as in ``easyrag_tpu``, so one YAML
file configures both packages).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml


@dataclass
class TPUConfig:
    """Execution knobs with no reference equivalent. The section keeps the
    JAX package's name and fields, so one YAML file configures both
    packages. ``mesh_shape`` / ``shard_index`` shard the retrieval indexes
    over the mesh's ``data`` axis (``parallel/``); a ``model`` axis wider
    than 1 raises ``NotImplementedError`` where a model is loaded (tensor
    parallelism is not ported yet)."""

    mesh_shape: Optional[List[int]] = None  # None -> all devices on one axis
    mesh_axis_names: List[str] = field(default_factory=lambda: ["data"])
    index_dtype: str = "bfloat16"  # dense index dtype
    accum_dtype: str = "float32"  # dense score dtype
    use_pallas: bool = True  # the overflow BM25 scatter through K5's wrapper
    compile_cache_dir: str = ""  # persistent executable cache ("" = off)
    # max tokenized query terms / gathered postings per query (static shapes)
    max_query_terms: int = 64
    max_query_postings: int = 32768
    query_batch: int = 32  # query microbatch for batched retrieval
    # weight storage: "" (bf16) | "int8" | "w8a8" | "int4" | "w4a8"
    embedder_quant: str = ""
    reranker_quant: str = ""
    # r_use_efficient=3: pairs re-scored at full depth (must be >= r_topk),
    # and whether stage 2 resumes from stage 1's hidden states
    cascade_keep: int = 32
    cascade_carry: bool = False
    # resident sparse heavy matrix: float32 | bfloat16 | int8, and its budget
    sparse_heavy_dtype: str = "float32"
    sparse_heavy_hbm_budget: int = 512 * 1024 * 1024
    # budget of the padded term-major light-postings tables ((V+1)*C*8 bytes
    # per index); over budget the CSR layout is used
    sparse_light_rows_hbm_budget: int = 256 * 1024 * 1024
    # backend for local_llm_name: "jax" is the package's own KV-cache decoder
    # (models/decode.py here), "hf" the HuggingFace wrapper
    local_llm_backend: str = "jax"
    local_llm_quant: str = "int8"  # "" | "int8" | "w8a8" | "int4" | "w4a8"
    local_llm_answer: bool = False  # the local decoder answers (pipeline.llm)
    local_llm_max_new: int = 0  # cap on generated tokens (0: up to 8192 in all)
    local_llm_gen_batch: int = 8  # max rows per batched generation dispatch
    local_llm_continuous: bool = False  # continuous batching (decode pool)
    local_llm_chunk_steps: int = 32  # decode steps per pool dispatch
    local_llm_pool_tiers: str = ""  # per-bucket pool slots, "bucket:slots,..."
    local_llm_warmup: bool = False  # build every generation shape at boot
    local_llm_spec: int = 0  # prompt-lookup draft tokens per verify step
    local_llm_spec_ngram: int = 2  # n-gram the draft lookup matches on
    shard_index: bool = False  # shard the retrieval indexes over the mesh


@dataclass
class EasyRAGConfig:
    # -- pipeline modes (easyrag.yaml:1-3) --
    rerank_fusion_type: int = 0  # 0 none | 1 rrf of two routes | 2 longest | 3 concat
    ans_refine_type: int = 0  # 0 none | 1 LLM merge w/ top1 | 2 concat top1

    # -- coarse ranking (easyrag.yaml:5-11) --
    re_only: bool = False
    retrieval_type: int = 2  # 1 dense | 2 sparse | 3 hybrid
    f_topk: int = 256  # hybrid fusion topk
    f_topk_1: int = 288  # dense coarse topk
    f_topk_2: int = 192  # sparse coarse topk
    f_topk_3: int = 6  # know-path route topk (0 disables the route)

    # -- dense retriever (easyrag.yaml:13-18) --
    reindex: bool = False
    embedding_name: str = "Alibaba-NLP/gte-Qwen2-7B-instruct"
    vector_size: int = 3584
    cache_path: str = "cache"
    collection_name: str = "aiops24"

    # -- sparse retriever (easyrag.yaml:20-21) --
    bm25_type: int = 0  # 0 okapi (epsilon IDF floor) | 1 eager/robertson (bm25s)

    # -- reranker (easyrag.yaml:23-29) --
    r_topk: int = 6
    r_topk_1: int = 6
    reranker_name: str = "BAAI/bge-reranker-v2-minicpm-layerwise"
    use_reranker: int = 2  # 0 none | 1 cross-encoder | 2 layerwise LLM reranker
    r_embed_bs: int = 32
    # 0 off | 1 max-prob early exit | 2 entropy early exit |
    # 3 two-stage cascade (see rerankers.py and tpu.cascade_keep)
    r_use_efficient: int = 0

    # -- generation (easyrag.yaml:31-37) --
    llm_keys: List[str] = field(default_factory=list)
    llm_name: str = "glm-4"
    llm_api_base: str = "https://open.bigmodel.cn/api/paas/v4/"
    llm_embed_type: int = 3

    # -- content view encodings (easyrag.yaml:39-42) --
    f_embed_type_1: int = 1  # dense document view
    f_embed_type_2: int = 2  # sparse document view
    r_embed_type: int = 1  # rerank document view

    # -- chunking (easyrag.yaml:44-47) --
    split_type: int = 0  # 0 sentence | 1 hierarchical
    chunk_size: int = 1024
    chunk_overlap: int = 200

    # -- paths (easyrag.yaml:49-52) --
    data_path: str = "../data/format_data_with_img"
    hfmodel_cache_folder: str = ""
    stopwords_path: str = ""  # default: packaged HIT list
    index_artifact_path: str = ""  # on-disk index artifact (qdrant-collection analog)

    # -- local LLM (easyrag.yaml:54-55) --
    local_llm_name: str = ""

    # -- context compression (easyrag.yaml:57-59) --
    compress_method: str = ""  # "" | bm25_extract | llmlingua | longllmlingua
    compress_rate: float = 0.5

    # -- HyDE (easyrag.yaml:61-63) --
    hyde: bool = False
    hyde_merging: bool = False

    # -- serving batcher (new; the reference serves strictly per-request) --
    serve_window_ms: float = 4.0  # request-coalescing window
    serve_max_batch: int = 32  # max coalesced retrieval batch
    serve_coalesce_rerank: bool = True  # fuse reranker batches across requests

    # -- execution knobs (no reference counterpart) --
    tpu: TPUConfig = field(default_factory=TPUConfig)

    def __post_init__(self) -> None:
        if self.chunk_overlap > self.chunk_size:
            raise ValueError(
                f"chunk_overlap ({self.chunk_overlap}) > chunk_size ({self.chunk_size})"
            )
        if self.retrieval_type not in (1, 2, 3):
            raise ValueError(f"retrieval_type must be 1|2|3, got {self.retrieval_type}")
        if self.use_reranker not in (0, 1, 2):
            raise ValueError(f"use_reranker must be 0|1|2, got {self.use_reranker}")
        if self.bm25_type not in (0, 1):
            raise ValueError(f"bm25_type must be 0|1, got {self.bm25_type}")

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "EasyRAGConfig":
        known = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        extra: Dict[str, Any] = {}
        tpu_fields = {f.name for f in dataclasses.fields(TPUConfig)}
        for key, value in raw.items():
            if key == "tpu" and isinstance(value, dict):
                # unknown tpu.* knobs survive in extra (like fire's dict
                # merge at the top level) instead of a raw TypeError
                kwargs["tpu"] = TPUConfig(
                    **{k: v for k, v in value.items() if k in tpu_fields}
                )
                for k, v in value.items():
                    if k not in tpu_fields:
                        extra[f"tpu.{k}"] = v
            elif key in known:
                kwargs[key] = value
            else:
                extra[key] = value
        cfg = cls(**kwargs)
        # tolerate reference-yaml keys we intentionally don't model
        cfg.extra = extra  # type: ignore[attr-defined]
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def parse_pool_tiers(spec: str) -> Optional[List[tuple]]:
    """Parse ``tpu.local_llm_pool_tiers`` ("2048:2,7680:2") into
    ``[(bucket, slots), ...]``; "" -> None (single largest-bucket tier)."""
    if not spec:
        return None
    tiers = []
    for part in str(spec).split(","):
        bucket, _, slots = part.partition(":")
        try:
            tiers.append((int(bucket), int(slots)))
        except ValueError:
            raise ValueError(f"tpu.local_llm_pool_tiers expects 'bucket:slots,...', got {spec!r}") from None
    return tiers


def parse_override(spec: str) -> (str, Any):
    """Parse one ``key=value`` CLI override into a typed ``(key, value)``.

    This is the argparse stand-in for fire's arbitrary-kwargs merge
    (``src/main.py:21-32``): the reference accepts ANY ``--knob value`` and
    folds it into the raw config dict. Values are typed by YAML rules
    (``1`` -> int, ``0.4`` -> float, ``true`` -> bool, ``[1,2]`` -> list,
    anything else -> str). Dotted keys address the ``tpu`` section
    (``tpu.query_batch=16``).
    """
    if "=" not in spec:
        raise ValueError(f"--set expects key=value, got {spec!r}")
    key, _, text = spec.partition("=")
    key = key.strip()
    if not key:
        raise ValueError(f"--set expects key=value, got {spec!r}")
    try:
        value = yaml.safe_load(text) if text != "" else ""
    except yaml.YAMLError:
        value = text
    return key, value


def apply_overrides(raw: Dict[str, Any], overrides: Dict[str, Any]) -> None:
    """Merge typed overrides into the raw config dict in place.

    Dotted keys update nested sections (currently ``tpu.*``); plain keys
    replace top-level entries — exactly fire's ``config[key] = value``
    behavior in ``src/main.py:30-32``, unknown keys included (they survive
    in ``EasyRAGConfig.extra``).
    """
    for key, value in overrides.items():
        if "." in key:
            head, _, rest = key.partition(".")
            section = raw.get(head)
            if section is None:  # absent, or a bare `tpu:` line (YAML None)
                section = {}
                raw[head] = section
            if not isinstance(section, dict):
                raise ValueError(f"cannot set {key!r}: {head!r} is not a section")
            section[rest] = value
        else:
            raw[key] = value


def load_config(
    path: str,
    overrides: Optional[Dict[str, Any]] = None,
    set_specs: Optional[List[str]] = None,
) -> EasyRAGConfig:
    """YAML -> :class:`EasyRAGConfig`, CLI-override merge like ``main.py:30-32``.

    ``overrides`` are already-typed values from fixed CLI flags;
    ``set_specs`` are raw ``key=value`` strings from ``--set`` (fire-style
    arbitrary knobs), typed by :func:`parse_override`.
    """
    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}
    merged: Dict[str, Any] = {}
    if overrides:
        merged.update(overrides)
    for spec in set_specs or []:
        key, value = parse_override(spec)
        merged[key] = value
    apply_overrides(raw, merged)
    return EasyRAGConfig.from_dict(raw)
