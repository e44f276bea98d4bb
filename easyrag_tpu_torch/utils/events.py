"""Event-hook seam + profiling.

The reference's only instrumentation is llama-index CallbackManager events
around chunking, node parsing, and reranking. The same seam is a
process-global hook registry: components ``emit(kind, payload)``, listeners
subscribe with :func:`on`. :func:`trace` times a block and emits a
``timing`` event; with ``EASYRAG_TRACE_DIR`` set it also exports a
``torch.profiler`` trace of the block there (CPU activity, and the card's
kernels when there is one), one Chrome-trace JSON file per block.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Callable, Dict, List

logger = logging.getLogger("easyrag_tpu_torch")

_listeners: List[Callable[[str, Dict[str, Any]], None]] = []


def on(listener: Callable[[str, Dict[str, Any]], None]) -> Callable[[], None]:
    """Subscribe to events; returns an unsubscribe callable."""
    _listeners.append(listener)
    return lambda: _listeners.remove(listener)


def emit(kind: str, payload: Dict[str, Any]) -> None:
    logger.debug("event %s %s", kind, payload)
    for listener in list(_listeners):
        try:
            listener(kind, payload)
        except Exception:  # pragma: no cover - listeners must not break flow
            logger.exception("event listener failed for %s", kind)


@contextlib.contextmanager
def trace(name: str):
    """Time a block; export a ``torch.profiler`` trace when
    ``EASYRAG_TRACE_DIR`` is set."""
    trace_dir = os.environ.get("EASYRAG_TRACE_DIR")
    start = time.perf_counter()
    if trace_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}-{os.getpid()}-{time.time_ns()}.json"))
    else:
        yield
    emit("timing", {"name": name, "seconds": time.perf_counter() - start})
