"""Utilities: event hooks and a sync bridge for coroutines."""

import asyncio


def run_sync(coro):
    """Run a coroutine to completion from synchronous code.

    ``asyncio.get_event_loop()`` raises on Python 3.12 once the thread's
    loop has been consumed (e.g. by a prior ``asyncio.run`` anywhere in
    the process); keep a thread-local loop alive instead — the sync
    ``complete``/``retrieve`` wrappers are called repeatedly and their
    objects create all async state fresh per call, so loop reuse is safe.
    """
    try:
        loop = asyncio.get_event_loop()
    except RuntimeError:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
    if loop.is_closed():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
    return loop.run_until_complete(coro)
