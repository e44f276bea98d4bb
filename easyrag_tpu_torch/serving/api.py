"""HTTP serving API (port of ``easyrag_tpu/serving/api.py``).

Replaces the reference's FastAPI service (``src/api.py``): permissive CORS,
``GET /test`` smoke endpoint, ``GET /ui`` (the browser client), ``POST
/v1/rag`` taking ``{"query": ..., "document": optional}`` and returning
``{"answer", "contexts"}``. Built on aiohttp, as the JAX package's server
is (the card's machine has it); the route contract is the reference's, so
its web UI and clients work unchanged.

Retrieval-only deployments (``re_only`` on the default route) get request
micro-batching: concurrent requests within a small window coalesce into one
``pipeline.run_retrieval_batch`` call. Full-RAG deployments instead get
cross-request reranker coalescing (``serving/coalesce.py``): concurrent
requests' pair batches fuse into shared device dispatches. With
``tpu.local_llm_continuous`` the answers come from the decode pool
(``models/decode_pool.py``), which admits requests into a running decode.
Window and batch are config knobs (``serve_window_ms``, ``serve_max_batch``,
``serve_coalesce_rerank``).

Before the socket opens, the port's CUDA kernels are built (when the
pipeline is on the card) and, with ``tpu.local_llm_warmup``, every
generation shape runs once, so neither lands on a request.

Run:  python -m easyrag_tpu_torch.serving.api --config configs/four_tenant.yaml
(on the card; ``--device cpu`` runs on the CPU)
"""

from __future__ import annotations

import argparse
import asyncio
import time
from typing import Optional

import torch

from ..config import EasyRAGConfig, load_config
from ..pipeline import EasyRAGPipeline


class RetrievalBatcher:
    """Coalesce concurrent retrieval-only requests into device batches."""

    def __init__(self, pipeline: EasyRAGPipeline, window_ms: float = 4.0, max_batch: int = 32) -> None:
        self.pipeline = pipeline
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self._pending: list = []
        self._flusher: Optional[asyncio.Task] = None

    async def run(self, query: dict) -> dict:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((query, fut))
        if len(self._pending) >= self.max_batch:
            await self._flush()
        elif self._flusher is None or self._flusher.done():
            self._flusher = asyncio.ensure_future(self._delayed_flush())
        return await fut

    async def _delayed_flush(self) -> None:
        await asyncio.sleep(self.window)
        await self._flush()

    async def _flush(self) -> None:
        batch, self._pending = self._pending, []
        if not batch:
            return
        queries = [q for q, _ in batch]
        try:
            results = await self.pipeline.run_retrieval_batch(queries)
            for (_, fut), res in zip(batch, results):
                if not fut.done():
                    fut.set_result(res)
        except Exception as e:  # noqa: BLE001 — fail all waiters
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


def warm_generation(pipeline: EasyRAGPipeline) -> None:
    """``tpu.local_llm_warmup``: run every generation shape the server can
    hit once: the decode pool's (tier, bucket) pairs and chunks under
    ``tpu.local_llm_continuous``, else every (bucket, B) of the batched
    decoder at each power-of-two batch up to ``local_llm_gen_batch``."""
    cfg = pipeline.config
    local = pipeline.local_llm
    if not cfg.tpu.local_llm_warmup or local is None or not hasattr(local, "warmup"):
        return
    sizes = [b for b in (1, 2, 4, 8, 16, 32) if b <= cfg.tpu.local_llm_gen_batch] or [1]
    t0 = time.perf_counter()
    if cfg.tpu.local_llm_continuous:
        pipeline.llm.warmup(buckets=local.buckets)
    else:
        local.warmup(buckets=local.buckets, batch_sizes=sizes)
    print(f"[serving] generation warmup: buckets={list(local.buckets)} batch_sizes={sizes} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def create_app(pipeline: EasyRAGPipeline):
    """The aiohttp application over ``pipeline``: installs the rerank
    coalescer (full RAG) or the retrieval batcher (``re_only``), builds the
    kernels and warms generation, then the routes."""
    from aiohttp import web

    from .. import _build

    routes = web.RouteTableDef()
    cfg = pipeline.config
    batcher = (
        RetrievalBatcher(pipeline, window_ms=cfg.serve_window_ms, max_batch=cfg.serve_max_batch)
        if pipeline.re_only and cfg.rerank_fusion_type == 0
        else None
    )
    # full-RAG path: fuse reranker batches across concurrent requests (the
    # rerank stage dominates, and per-request tail batches waste padded rows
    # that other requests' pairs can fill)
    if (
        batcher is None
        and cfg.serve_coalesce_rerank
        and getattr(pipeline.reranker, "scorer", None) is not None
        and not getattr(pipeline.reranker.scorer, "coalesce", False)
    ):
        from .coalesce import CoalescingScorer

        pipeline.reranker.scorer = CoalescingScorer(
            pipeline.reranker.scorer,
            max_batch=getattr(pipeline.reranker, "embed_bs", cfg.serve_max_batch),
            window_ms=cfg.serve_window_ms,
        )
        pipeline.rerank_in_thread = True
    if pipeline.device.type == "cuda":
        t0 = time.perf_counter()
        _build.build(_build.KERNELS)
        print(f"[serving] kernels built in {time.perf_counter() - t0:.1f}s", flush=True)
    warm_generation(pipeline)

    @routes.get("/test")
    async def test(_request):
        return web.json_response("hello rag")

    @routes.get("/ui")
    async def ui(_request):
        # dependency-free browser client (the reference's streamlit layout
        # without the streamlit runtime, src/webui.py:20-47)
        from .webui import HTML_PAGE

        return web.Response(text=HTML_PAGE, content_type="text/html")

    @routes.post("/v1/rag")
    async def rag(request):
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001 — any unparsable body is the client's fault
            return web.json_response({"error": "body must be JSON"}, status=400)
        query = {"query": body.get("query", ""), "document": body.get("document", "")}
        try:
            if batcher is not None:
                res = await batcher.run(query)
            else:
                res = await pipeline.run(query)
        except Exception as e:  # noqa: BLE001 — surface as clean JSON 500
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"answer": res["answer"], "contexts": res["contexts"]})

    app = web.Application()
    app.add_routes(routes)

    # permissive CORS (the reference's api.py:24-30)
    @web.middleware
    async def cors(request, handler):
        resp = web.Response() if request.method == "OPTIONS" else await handler(request)
        resp.headers["Access-Control-Allow-Origin"] = "*"
        resp.headers["Access-Control-Allow-Methods"] = "*"
        resp.headers["Access-Control-Allow-Headers"] = "*"
        return resp

    app.middlewares.append(cors)
    return app


def serve(
    config: Optional[EasyRAGConfig] = None,
    pipeline: Optional[EasyRAGPipeline] = None,
    host: str = "0.0.0.0",
    port: int = 8000,
    device: torch.device | str = "cuda",
) -> None:
    """Boot ``EasyRAGPipeline(config)`` on ``device`` (the card unless the
    caller asks for the CPU; without a card it raises) and serve it."""
    from aiohttp import web

    if pipeline is None:
        pipeline = EasyRAGPipeline(config, device=device)
    web.run_app(create_app(pipeline), host=host, port=port)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", default="configs/easyrag.yaml")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    serve(config=load_config(args.config), host=args.host, port=args.port, device=args.device)


if __name__ == "__main__":
    main()
