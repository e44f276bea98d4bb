"""LLM generation: OpenAI-compatible async client, retry policy, HyDE.

Replaces the reference's llama-index ``OpenAILike`` GLM-4 client
(``src/easyrag/pipeline/pipeline.py:71-78``) with a thin aiohttp client, and
``generation()``'s retry-10-then-"无法确定" policy
(``src/easyrag/pipeline/rag.py:26-39``). ``HyDETransform`` mirrors
llama-index's ``HyDEQueryTransform`` with ``include_original=True``: the
pseudo-document is ``custom_embedding_strs[0]``
(consumed at ``pipeline.py:328-330``).

Sentence cutting (:func:`cut_sent`) replicates the regex splitter at
``rag.py:6-14`` used by the bm25_extract compressor.
"""

from __future__ import annotations

import asyncio
import random
import re
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence

from .schema import QueryBundle
from .utils import run_sync
from .templates import PromptTemplate


@dataclass
class CompletionResponse:
    text: str


class OpenAICompatLLM:
    """Async chat-completions client for any OpenAI-compatible endpoint
    (GLM-4 at ``https://open.bigmodel.cn/api/paas/v4/`` in the reference)."""

    def __init__(
        self,
        api_keys: Sequence[str],
        model: str = "glm-4",
        api_base: str = "https://open.bigmodel.cn/api/paas/v4/",
        timeout_s: float = 120.0,
    ) -> None:
        if not api_keys:
            raise ValueError("at least one API key required")
        # reference picks one key at random per pipeline (pipeline.py:71)
        self.api_key = random.choice(list(api_keys))
        self.model = model
        self.api_base = api_base.rstrip("/")
        self.timeout_s = timeout_s

    async def acomplete(self, prompt: str) -> CompletionResponse:
        import aiohttp

        url = f"{self.api_base}/chat/completions"
        payload = {
            "model": self.model,
            "messages": [{"role": "user", "content": prompt}],
        }
        headers = {"Authorization": f"Bearer {self.api_key}"}
        timeout = aiohttp.ClientTimeout(total=self.timeout_s)
        async with aiohttp.ClientSession(timeout=timeout) as session:
            async with session.post(url, json=payload, headers=headers) as resp:
                resp.raise_for_status()
                data = await resp.json()
        return CompletionResponse(text=data["choices"][0]["message"]["content"])

    def complete(self, prompt: str) -> CompletionResponse:
        return run_sync(self.acomplete(prompt))


class BatchingLocalLLM:
    """On-device answer generation with cross-request batching (no
    reference equivalent — the reference's generation stage is a network
    call, ``rag.py:26-39``).

    Wraps a local decoder (``models.decode.TorchCausalLM`` or anything with
    ``generate_batch``/``generate``) behind the pipeline's async
    ``acomplete`` LLM contract. Concurrent prompts within a window fuse
    into one batched decode: the KV-cache step is weight-bandwidth-bound,
    so extra rows cost little and serving throughput on the generation
    stage grows with the batch. While a batch occupies the device, new
    arrivals keep queueing — under saturation the flusher naturally drains
    the whole backlog as one batch.
    """

    def __init__(self, model, window_ms: float = 4.0, max_batch: int = 8) -> None:
        self.model = model
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self._pending: list = []
        self._flusher: Optional[asyncio.Task] = None
        self._busy: Optional[asyncio.Lock] = None  # created on first use
        self.dispatches = 0  # batched device calls (observability/tests)

    async def acomplete(self, prompt: str) -> CompletionResponse:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((prompt, fut))
        if self._busy is None:
            self._busy = asyncio.Lock()
        # (a pending window-flusher is left alone even when this flush
        # supersedes it — it may be mid-dispatch, and an empty follow-up
        # flush is a no-op; cancelling could orphan in-flight waiters)
        if len(self._pending) >= self.max_batch:
            await self._flush()
        elif self._flusher is None or self._flusher.done():
            self._flusher = asyncio.ensure_future(self._delayed_flush())
        return await fut

    async def _delayed_flush(self) -> None:
        await asyncio.sleep(self.window)
        await self._flush()

    async def _flush(self) -> None:
        # serialize on the device: waiting here (rather than dispatching a
        # second batch mid-decode) lets arrivals pile into a fuller batch
        async with self._busy:
            batch, self._pending = (
                self._pending[: self.max_batch],
                self._pending[self.max_batch :],
            )
            if not batch:
                return
            prompts = [p for p, _ in batch]
            try:
                self.dispatches += 1
                if hasattr(self.model, "generate_batch"):
                    texts = await asyncio.to_thread(
                        self.model.generate_batch, prompts
                    )
                else:  # per-item fallback (e.g. the torch LocalHFLLM)
                    texts = await asyncio.to_thread(
                        lambda: [self.model.generate(p) for p in prompts]
                    )
                for (_, fut), text in zip(batch, texts):
                    if not fut.done():
                        fut.set_result(CompletionResponse(text=text))
            except Exception as e:  # noqa: BLE001 — fail all waiters
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
        flusher = self._flusher
        if self._pending and (flusher is None or flusher.done() or flusher is asyncio.current_task()):
            # backlog left by the max_batch cut, or arrivals during this
            # dispatch (they saw this flusher running and armed none): hand
            # it to a fresh flusher instead of draining inline (the waiter
            # that triggered this flush must not block on later batches).
            # JAX's check leaves out the running flusher itself, so a
            # request that arrives during the last dispatch waits forever.
            self._flusher = asyncio.ensure_future(self._delayed_flush())

    def complete(self, prompt: str) -> CompletionResponse:
        return run_sync(self.acomplete(prompt))


class ContinuousBatchingLocalLLM:
    """Continuous batching over the on-device decoder (see
    ``models/decode_pool.py`` for the design). Same ``acomplete`` contract
    as :class:`BatchingLocalLLM`, but instead of fusing requests that arrive
    within a window, requests JOIN a running decode at chunk boundaries, so
    arrivals staggered by the rerank stage overlap instead of serializing.

    A single driver task owns the pool: it admits queued prompts into free
    slots (prefill at the prompt's own bucket), dispatches decode chunks,
    and resolves futures as rows finish. All device work runs in a worker
    thread so the event loop keeps serving. The pool lives on the model's
    device: the card unless its caller asked for the CPU.
    """

    def __init__(self, model, pool_size: int = 4, chunk_steps: int = 32, tiers=None) -> None:
        from .models.decode_pool import DecodePool

        self.model = model
        self.pool = DecodePool(model, pool_size=pool_size, chunk_steps=chunk_steps, tiers=tiers)
        self._queue: deque = deque()
        self._driver: Optional[asyncio.Task] = None
        self.dispatches = 0  # chunk dispatches (observability/tests)

    def warmup(self, buckets=None, batch_sizes=None) -> None:
        """Run the pool's shapes once at boot (a prefill and insert per
        (tier, bucket), a chunk per tier). ``batch_sizes`` is accepted for
        call-site parity with ``TorchCausalLM.warmup``; the pool's batch is
        fixed."""
        del batch_sizes
        self.pool.warmup(buckets=buckets)

    async def acomplete(self, prompt: str) -> CompletionResponse:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._queue.append((prompt, fut))
        if self._driver is None or self._driver.done():
            self._driver = asyncio.ensure_future(self._drive())
        return await fut

    async def _drive(self) -> None:
        pool = self.pool
        while self._queue or pool.active:
            # admit waiters while a fitting tier has a free slot (a long
            # prompt must WAIT when only small-tier slots are free, not
            # fail; head-of-line order is kept so waiters can't starve)
            while self._queue:
                prompt, fut = self._queue[0]
                try:
                    ids = self.model._encode(prompt)
                except Exception as e:  # noqa: BLE001 — fail this waiter only
                    self._queue.popleft()
                    if not fut.done():
                        fut.set_exception(e)
                    continue
                if not pool.fits(ids):
                    # no tier holds its bucket: it would wait forever (JAX's
                    # driver spins here without yielding)
                    self._queue.popleft()
                    if not fut.done():
                        fut.set_exception(ValueError(
                            f"prompt of {len(ids)} tokens: no pool tier holds its bucket "
                            f"(tiers {[(t.bucket, t.slots) for t in pool.tiers]})"))
                    continue
                if not pool.can_admit(ids):
                    break
                self._queue.popleft()
                try:
                    await asyncio.to_thread(pool.insert, ids, fut)
                except Exception as e:  # noqa: BLE001 — fail this waiter only
                    if not fut.done():
                        fut.set_exception(e)
            if not pool.active:
                continue
            try:
                finished = await asyncio.to_thread(pool.run_chunk)
                self.dispatches += 1
            except Exception as e:  # noqa: BLE001 — device failure: fail every live row
                for fut in list(pool.live.values()):
                    if fut is not None and not fut.done():
                        fut.set_exception(e)
                pool.reset()
                continue
            for fut, toks in finished:
                if fut is not None and not fut.done():
                    fut.set_result(CompletionResponse(text=self.model._decode_row(toks)))

    def complete(self, prompt: str) -> CompletionResponse:
        return run_sync(self.acomplete(prompt))


async def generation(llm, fmt_qa_prompt: str, max_retries: int = 10) -> CompletionResponse:
    """Retry any exception up to ``max_retries`` times, then degrade to the
    literal answer "无法确定" (``rag.py:26-39``)."""
    cnt = 0
    while True:
        try:
            return await llm.acomplete(fmt_qa_prompt)
        except Exception as e:  # noqa: BLE001 — reference retries everything
            print(e)
            cnt += 1
            if cnt >= max_retries:
                print(f"已达到最大生成次数{cnt}次，返回'无法确定'")
                return CompletionResponse(text="无法确定")
            print(f"已重复生成{cnt}次")


class HyDETransform:
    """Generate a hypothetical document for the query and bundle it as
    ``custom_embedding_strs[0]`` (llama-index ``HyDEQueryTransform``,
    ``include_original=True``)."""

    def __init__(self, llm, hyde_prompt: str, include_original: bool = True) -> None:
        self.llm = llm
        self.prompt = PromptTemplate(hyde_prompt)
        self.include_original = include_original

    def __call__(self, query_str: str) -> QueryBundle:
        return run_sync(self.acall(query_str))

    async def acall(self, query_str: str) -> QueryBundle:
        resp = await generation(self.llm, self.prompt.format(context_str=query_str))
        embedding_strs: List[str] = [resp.text]
        if self.include_original:
            embedding_strs.append(query_str)
        return QueryBundle(query_str=query_str, custom_embedding_strs=embedding_strs)


def cut_sent(para: str) -> List[str]:
    """Chinese sentence cutter (``rag.py:6-14``): break after 。！？?,
    after ``......``/``……`` ellipses, and after closing quotes that follow a
    terminator."""
    para = re.sub(r"([。！？\?])([^”’])", r"\1\n\2", para)
    para = re.sub(r"(\.{6})([^”’])", r"\1\n\2", para)
    para = re.sub(r"(\…{2})([^”’])", r"\1\n\2", para)
    para = re.sub(r"([。！？\?][”’])([^，。！？\?])", r"\1\n\2", para)
    para = para.rstrip()
    return para.split("\n")


def deduplicate(contents: Sequence[str]) -> List[str]:
    """Order-preserving dedup (``rag.py:42-49``)."""
    seen = set()
    out: List[str] = []
    for c in contents:
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


class LocalHFLLM:
    """Optional local HuggingFace CausalLM generation
    (``src/easyrag/utils/llm_utils.py:58-73``): chat template, greedy
    ``top_k=1``, ``max_length=8192``."""

    def __init__(self, model_name: str) -> None:
        import torch
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(model_name, trust_remote_code=True)
        self.model = (
            AutoModelForCausalLM.from_pretrained(
                model_name,
                torch_dtype=torch.bfloat16,
                low_cpu_mem_usage=True,
                trust_remote_code=True,
            )
            .eval()
        )

    def generate(self, query: str) -> str:
        import torch

        messages = [{"role": "user", "content": query}]
        inputs = self.tokenizer.apply_chat_template(
            messages, add_generation_prompt=True, return_tensors="pt"
        )
        with torch.no_grad():
            out = self.model.generate(
                inputs, max_length=8192, top_k=1, do_sample=False
            )
        return self.tokenizer.decode(
            out[0][inputs.shape[1]:], skip_special_tokens=True
        )
