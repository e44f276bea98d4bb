"""Model registry: a name or local path -> an embedder or a reranker (port of
``easyrag_tpu/models/registry.py``).

The same name dispatch as the JAX package (the reference's
``src/easyrag/pipeline/pipeline.py:100-118`` for embeddings,
``src/easyrag/custom/rerankers.py:142-184`` for rerankers), with the models
on ``device`` (the card unless the caller asks for the CPU). Weights must be
local directories: a missing path raises with an instruction instead of
trying a download. There is no attention switch: the port's models pick
K1, K3 or K4 by the tensors' device.
"""

from __future__ import annotations

import os

import torch


def _require_local(name: str, kind: str) -> str:
    if os.path.isdir(name):
        return name
    raise FileNotFoundError(
        f"{kind} weights not found at '{name}'. This environment has no "
        "network egress; download the checkpoint ahead of time (see the "
        "reference's scripts/download.sh) and point the config at the local "
        "directory, or inject a model instance into EasyRAGPipeline."
    )


def load_embedder(
    name: str,
    cache_folder: str = "",
    embed_type: int = 0,
    mesh=None,
    quant: str = "",
    device: torch.device | str = "cuda",
):
    """Dense embedder by name. gte/Zhihui names take the Qwen2 last-token
    pool (``qwen2.load_gte_embedder``, 128-row embedding batches); with a
    ``mesh`` whose ``model`` axis is wider than 1 its decoder weights shard
    tensor-parallel over that axis (``parallel/tp.py``). Any other name is
    a sentence-transformers model (``STEmbedder``, on the host), which
    ignores the mesh, as in JAX."""
    model_dir = _require_local(name, "embedding model")
    if "gte" in name or "Zhihui" in name:
        from .qwen2 import load_gte_embedder

        return load_gte_embedder(model_dir, quant=quant, device=device, embed_type=embed_type, mesh=mesh)
    from .st_embedder import STEmbedder

    return STEmbedder.from_pretrained(model_dir, embed_type=embed_type)


def load_reranker(
    name: str,
    top_n: int = 6,
    embed_bs: int = 32,
    embed_type: int = 0,
    use_efficient: int = 0,
    use_st: bool = False,
    quant: str = "",
    cascade_keep: int = 32,
    cascade_carry: bool = False,
    device: torch.device | str = "cuda",
):
    """Reranker by name (``rerankers.py:142-184`` dispatch): a
    sentence-transformers cross-encoder with ``use_st``; the MiniCPM
    layerwise scorer, the Gemma2 cost-wise scorer, or else the yes-logit
    scorer of a causal LM, each behind ``LLMRerank``."""
    from ..rerankers import LLMRerank, SentenceTransformerRerank

    model_dir = _require_local(name, "reranker model")
    if use_st:
        return SentenceTransformerRerank(top_n=top_n, model=model_dir)
    if "bge-reranker-v2-minicpm-layerwise" in name:
        from .hf_loader import load_hf_config
        from .minicpm import MiniCPMLayerWiseReranker

        scorer = MiniCPMLayerWiseReranker.from_pretrained(
            model_dir, quant=quant, device=device,
            # the reference's fixed cutoff (rerankers.py:162) clamped to the
            # checkpoint's depth, so reduced checkpoints load too
            cutoff_layer=min(28, load_hf_config(model_dir)["num_hidden_layers"]),
            use_efficient=use_efficient,
        )
        return LLMRerank(
            scorer, top_n=top_n, embed_bs=embed_bs, embed_type=embed_type, use_efficient=use_efficient,
            cascade_keep=cascade_keep, cascade_carry=cascade_carry,
        )
    if "bge-reranker-v2.5-gemma2-lightweight" in name:
        from .gemma import load_gemma_reranker

        scorer = load_gemma_reranker(model_dir, quant=quant, device=device)
        return LLMRerank(
            scorer, top_n=top_n, embed_bs=embed_bs, embed_type=embed_type,
            use_efficient=use_efficient if use_efficient == 3 else 0,
            cascade_keep=cascade_keep, cascade_carry=cascade_carry,
        )
    from .yes_logit import YesLogitScorer

    scorer = YesLogitScorer.from_pretrained(model_dir, quant=quant, device=device)
    # no cascade: the yes-logit scorer always runs its whole stack (its
    # cutoff_layer is informational), so a first stage would cost full depth
    return LLMRerank(scorer, top_n=top_n, embed_bs=embed_bs, embed_type=embed_type, use_efficient=0)
