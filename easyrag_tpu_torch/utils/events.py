"""Event-hook seam and spans.

The reference's only instrumentation is llama-index CallbackManager events
around chunking, node parsing, and reranking. The same seam is a
process-global hook registry: components ``emit(kind, payload)``, listeners
subscribe with :func:`on`.

:func:`trace` is the span: it times a block and emits a ``timing`` event
whose payload holds ``name``, ``seconds``, ``start`` and ``end``
(``time.perf_counter()`` at open and close), a process-unique ``id``, the
enclosing span's id as ``parent`` (None for a root) and the root's id as
``request``; a block that raises closes its span with ``error: True``. The
enclosing span is tracked in a ``ContextVar``, so concurrent asyncio tasks
keep their own requests and ``asyncio.to_thread`` workers their caller's.
While a ``torch.profiler`` records, the block also runs inside
``record_function(name)``: the span then sits in the profiler's host
timeline on the trace's own clock, over the kernels it launches. While a
listener is subscribed, every collection of Python's collector is a ``gc``
span, with its ``generation``.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import itertools
import logging
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("easyrag_tpu_torch")

_listeners: List[Callable[[str, Dict[str, Any]], None]] = []
_lock = threading.Lock()
_ids = itertools.count(1)
# (span id, request id) of the innermost open span
_current: contextvars.ContextVar[Optional[Tuple[int, int]]] = contextvars.ContextVar("easyrag_span", default=None)
_gc_start = 0.0


def on(listener: Callable[[str, Dict[str, Any]], None]) -> Callable[[], None]:
    """Subscribe to events; returns an unsubscribe callable. The collector's
    hook is installed with the first listener and removed with the last."""
    with _lock:
        _listeners.append(listener)
        if _on_gc not in gc.callbacks:
            gc.callbacks.append(_on_gc)

    def off() -> None:
        with _lock:
            _listeners.remove(listener)
            if not _listeners and _on_gc in gc.callbacks:
                gc.callbacks.remove(_on_gc)

    return off


def emit(kind: str, payload: Dict[str, Any]) -> None:
    logger.debug("event %s %s", kind, payload)
    for listener in list(_listeners):
        try:
            listener(kind, payload)
        except Exception:  # pragma: no cover - listeners must not break flow
            logger.exception("event listener failed for %s", kind)


def _span(name: str, start: float, end: float, span: int, outer: Optional[Tuple[int, int]]) -> Dict[str, Any]:
    return {"name": name, "seconds": end - start, "start": start, "end": end, "id": span,
            "parent": outer[0] if outer else None, "request": outer[1] if outer else span}


def _profiling() -> bool:
    """Whether a ``torch.profiler`` is recording (its module flag; no
    profiler can be without the module)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


@contextlib.contextmanager
def trace(name: str):
    """Time a block as a span (the module's docstring)."""
    outer = _current.get()
    span = next(_ids)
    token = _current.set((span, outer[1] if outer else span))
    ranged = None
    if _profiling():
        from torch.profiler import record_function

        ranged = record_function(name)
        ranged.__enter__()
    start = time.perf_counter()
    ok = False
    try:
        yield
        ok = True
    finally:
        end = time.perf_counter()
        if ranged is not None:
            ranged.__exit__(None, None, None)
        _current.reset(token)
        payload = _span(name, start, end, span, outer)
        if not ok:
            payload["error"] = True
        emit("timing", payload)


def _on_gc(phase: str, info: Dict[str, Any]) -> None:
    """``gc.callbacks`` hook: one ``gc`` span a collection, a child of the
    span it interrupted."""
    global _gc_start
    if phase == "start":
        _gc_start = time.perf_counter()
        return
    payload = _span("gc", _gc_start, time.perf_counter(), next(_ids), _current.get())
    payload["generation"] = info["generation"]
    emit("timing", payload)
