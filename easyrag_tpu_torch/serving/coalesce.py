"""Cross-request reranker coalescing for the full-RAG serve path (port of
``easyrag_tpu/serving/coalesce.py``).

The reranker is the pipeline's dominant stage (``src/easyrag/custom/
rerankers.py:307-345`` batches one query's pairs at ``embed_bs``). Under
concurrent serving, each request's tail batch wastes padded rows;
:class:`CoalescingScorer` shares dispatches ACROSS requests: requests
enqueue their (query, passage) pairs, a dispatcher thread drains the queue
every ``window_ms`` and packs pairs from different requests into full
``max_batch``-sized device batches.

Semantics preserved:

* judge batches (the early-exit protocol) pass through un-coalesced, under
  the device lock: the exit criterion softmaxes over the batch, so foreign
  pairs would perturb it (``efficient_modeling_minicpm_reranker.py:
  1259-1276``);
* ``cutoff_layer`` is a per-thread view: each request's discovered exit
  layer applies only to its own remaining pairs, and dispatches are grouped
  by cutoff. A thread that has set none sees the scorer's cutoff as it was
  when the proxy was built, never the group cutoff the dispatcher sets on
  the scorer for the length of a dispatch (JAX's view falls back to the
  scorer's live attribute, so a rerank that starts meanwhile takes a
  cascade's judge layer as its full depth);
* tail chunks are padded by duplicating the last pair (scores sliced off)
  to a halving bucket (``rerankers.tail_bucket``);
* an error fails every request of the batch.

JAX's warm bookkeeping (tail shapes dispatched at the full batch until their
XLA program is compiled off the latency path) has no counterpart: the port
compiles nothing per shape, and ``serving.api`` builds the kernels before
its socket opens.

The pipeline runs its rerank stage in a worker thread when
``pipeline.rerank_in_thread`` is set (the serving layer sets it), so
concurrent requests overlap in this stage and their pairs meet in the queue.
``LLMRerank`` runs the cascade without its carry behind a coalescing scorer,
as JAX does.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..rerankers import tail_bucket


class _Request:
    __slots__ = ("pairs", "cutoff", "event", "scores", "layer", "error")

    def __init__(self, pairs, cutoff):
        self.pairs = pairs
        self.cutoff = cutoff
        self.event = threading.Event()
        self.scores: Optional[Any] = None
        self.layer: Optional[int] = None
        self.error: Optional[BaseException] = None


class CoalescingScorer:
    """Thread-safe proxy over a pair scorer that fuses non-judge scoring
    work from concurrent threads into shared device dispatches."""

    #: LLMRerank checks this to hand over whole pair lists instead of
    #: pre-chunking (pre-chunked and padded batches could not be fused).
    coalesce = True

    def __init__(self, scorer, max_batch: int = 32, window_ms: float = 4.0) -> None:
        self.scorer = scorer
        self._default_cutoff = scorer.cutoff_layer
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self._tls = threading.local()
        self._device_lock = threading.Lock()  # serializes real-scorer calls
        self._cond = threading.Condition()
        self._queue: List[_Request] = []
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        #: real pair counts of recent dispatches, and how many requests'
        #: pairs each held (bounded: a long-running server must not leak)
        self.dispatch_sizes: collections.deque = collections.deque(maxlen=4096)
        self.dispatch_requests: collections.deque = collections.deque(maxlen=4096)

    # -- per-thread cutoff view ------------------------------------------------

    @property
    def cutoff_layer(self) -> int:
        return getattr(self._tls, "cutoff", self._default_cutoff)

    @cutoff_layer.setter
    def cutoff_layer(self, value: int) -> None:
        self._tls.cutoff = value

    # -- scoring ----------------------------------------------------------------

    def score_pairs(self, pairs: List[Tuple[str, str]], judge: bool = False) -> Tuple[Any, int]:
        if judge:
            # early-exit protocol: batch composition is semantic, no fusing
            with self._device_lock:
                saved = self.scorer.cutoff_layer
                self.scorer.cutoff_layer = self.cutoff_layer
                try:
                    scores, layer = self.scorer.score_pairs(pairs, judge=True)
                finally:
                    self.scorer.cutoff_layer = saved
                self.dispatch_sizes.append(len(pairs))
                self.dispatch_requests.append(1)
            return scores, layer
        req = _Request(list(pairs), self.cutoff_layer)
        with self._cond:
            if self._closed:
                raise RuntimeError("CoalescingScorer is closed")
            self._queue.append(req)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._dispatch_loop, name="rerank-coalescer", daemon=True)
                self._thread.start()
            self._cond.notify()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.scores, req.layer

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- dispatcher --------------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
            # collection window: let concurrent requests reach the queue
            time.sleep(self.window)
            with self._cond:
                batch, self._queue = self._queue, []
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch: List[_Request]) -> None:
        # group by cutoff: each group is scored at its own depth
        groups: Dict[int, List[_Request]] = {}
        for req in batch:
            groups.setdefault(req.cutoff, []).append(req)
        try:
            for cutoff, reqs in groups.items():
                flat: List[Tuple[str, str]] = []
                owner: List[int] = []
                spans: List[Tuple[_Request, int, int]] = []
                for k, req in enumerate(reqs):
                    spans.append((req, len(flat), len(flat) + len(req.pairs)))
                    flat.extend(req.pairs)
                    owner.extend([k] * len(req.pairs))
                all_scores: List[float] = []
                with self._device_lock:
                    saved = self.scorer.cutoff_layer
                    self.scorer.cutoff_layer = cutoff
                    try:
                        for lo in range(0, len(flat), self.max_batch):
                            chunk = flat[lo : lo + self.max_batch]
                            n_real = len(chunk)
                            if n_real < self.max_batch:
                                # the tail pads to a halving bucket, not the full batch
                                chunk = chunk + [chunk[-1]] * (tail_bucket(n_real, self.max_batch) - n_real)
                            scores, _ = self.scorer.score_pairs(chunk, judge=False)
                            all_scores.extend(np.asarray(scores)[:n_real])
                            self.dispatch_sizes.append(n_real)
                            self.dispatch_requests.append(len(set(owner[lo : lo + n_real])))
                    finally:
                        self.scorer.cutoff_layer = saved
                for req, lo, hi in spans:
                    req.scores = np.asarray(all_scores[lo:hi], dtype=np.float32)
                    req.layer = cutoff
                    req.event.set()
        except BaseException as e:  # noqa: BLE001 — fail every waiter cleanly
            for req in batch:
                if not req.event.is_set():
                    req.error = e
                    req.event.set()
            if not isinstance(e, Exception):
                raise
