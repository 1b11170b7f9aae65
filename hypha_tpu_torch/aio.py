"""Asyncio task lifecycle helpers (a copy of the subset of
``hypha_tpu/aio.py`` that the Job Bridge uses: ``spawn``, ``reap`` and
``wait_quiet``). The reference's task-failure counter belongs to its
telemetry, which is not ported (ROADMAP.md, Queue 1: telemetry); a failed
background task is logged here and nothing more.

``asyncio.gather(..., return_exceptions=True)`` is the primitive that makes
the cancellation semantics right: child outcomes become return values, but
cancellation delivered to the *waiter* still raises through the await.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Awaitable, Coroutine, MutableSet

__all__ = ["spawn", "reap", "wait_quiet"]

log = logging.getLogger("hypha.torch.aio")


def spawn(
    coro: Coroutine[Any, Any, Any],
    *,
    name: "str | None" = None,
    tasks: "MutableSet[asyncio.Task] | None" = None,
    what: str = "",
    logger: "logging.Logger | None" = None,
) -> asyncio.Task:
    """``create_task`` with mandatory exception surfacing.

    ``tasks`` (usually the owner's ``self._tasks`` set) keeps a strong
    reference until completion; the done-callback logs non-cancellation
    failures.
    """
    task = asyncio.create_task(coro, name=name or what or None)
    if tasks is not None:
        tasks.add(task)
        task.add_done_callback(tasks.discard)
    label = what or name or getattr(coro, "__qualname__", "task")
    lg = logger or log

    def _surface(t: asyncio.Task) -> None:
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            lg.error("background task %r failed: %r", label, exc)

    task.add_done_callback(_surface)
    return task


async def reap(*tasks: "asyncio.Task | None") -> None:
    """Cancel the given tasks and await them to actual completion.

    Outcomes (results, exceptions, their cancellation) are absorbed —
    anything noteworthy was already logged by :func:`spawn`'s callback.
    Cancellation of the *caller* propagates normally, so shutdown paths
    built on ``reap`` stay cancellable.
    """
    live = [t for t in tasks if t is not None]
    for t in live:
        t.cancel()
    live = [t for t in live if not t.done()]
    while live:
        # Re-cancel periodically: a wait_for inside the task can swallow a
        # cancellation that races its inner future completing, and a single
        # .cancel() above would then leave this await parked forever.
        _done, pending = await asyncio.wait(live, timeout=1.0)
        for t in pending:
            t.cancel()
        live = list(pending)


async def wait_quiet(
    *aws: "Awaitable[Any] | None", timeout: "float | None" = None
) -> None:
    """Await things whose failure/result is someone else's problem.

    On timeout the awaitables are cancelled (``asyncio.wait_for``
    semantics) and the timeout is swallowed; caller cancellation always
    propagates.
    """
    live = [a for a in aws if a is not None]
    if not live:
        return
    gathered = asyncio.gather(*live, return_exceptions=True)
    if timeout is None:
        await gathered
        return
    try:
        await asyncio.wait_for(gathered, timeout)
    except asyncio.TimeoutError:
        pass
