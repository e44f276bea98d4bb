"""Closed-loop clients that drive a system's entry over the window.

A traffic file names its ``entry``, one of the system module's ``entries``:
an async call ``(system, questions)`` that sends a request of ``batch``
questions and returns one output per question. ``clients`` clients each
send their next request when the last one returns; they take the questions
of the cycle in turn and wrap around. Clients stop sending when the
window's seconds are up; the window closes when the last request in flight
returns, so every request sent in it counts, with all its time.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .corpus import question_kind


@dataclass
class Request:
    start: float
    end: float
    questions: List[Dict[str, Any]]
    ok: bool
    error: str = ""
    output: Optional[List[Any]] = None  # kept outputs: the entry's, one per question


@dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    requests: List[Request] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start


class ClosedLoop:
    def __init__(self, system, entry, questions: List[Dict[str, Any]], traffic: Dict[str, Any], keep) -> None:
        self.system = system
        self.entry = entry  # the system module's entry that the traffic names
        self.questions = questions
        self.traffic = traffic
        self.batch = traffic.get("batch", 1)
        self.keep = keep  # request number -> whether its outputs are kept
        self._next = 0

    def _take(self) -> List[Dict[str, Any]]:
        n = len(self.questions)
        qs = [self.questions[(self._next + j) % n] for j in range(self.batch)]
        self._next = (self._next + self.batch) % n
        return qs

    async def _call(self, qs):
        return await self.entry(self.system, qs)

    def warm(self) -> None:
        """One request of each kind of question the cycle holds (one request
        of a batch entry holds every kind); the cycle then starts over."""
        if self.batch > 1:
            firsts = [0]
        else:
            kinds: Dict[str, int] = {}
            for i in range(len(self.questions)):
                kinds.setdefault(question_kind(i, self.traffic), i)
            firsts = sorted(kinds.values())
        for i in firsts:
            self._next = i * self.batch % len(self.questions)
            asyncio.run(self._call(self._take()))
        self._next = 0

    def run(self, seconds: float, hooks) -> Window:
        """The window: ``hooks.open()`` as it opens, ``hooks.close()`` as it
        closes (the trace and the counters' readings)."""
        win = Window()

        async def client(deadline: float) -> None:
            while time.perf_counter() < deadline:
                qs = self._take()
                n = len(win.requests)
                req = Request(time.perf_counter(), 0.0, qs, False)
                win.requests.append(req)
                try:
                    out = await self._call(qs)
                    req.ok = True
                    if self.keep(n):
                        req.output = out
                except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
                    req.error = f"{type(e).__name__}: {e}"
                req.end = time.perf_counter()

        async def main() -> None:
            hooks.open()
            win.start = time.perf_counter()
            await asyncio.gather(*(client(win.start + seconds) for _ in range(self.traffic.get("clients", 1))))
            win.end = time.perf_counter()
            hooks.close()

        asyncio.run(main())
        return win

