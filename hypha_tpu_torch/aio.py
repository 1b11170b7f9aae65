"""Asyncio task lifecycle helpers (a copy of the subset of
``hypha_tpu/aio.py`` that the fabric, the worker runtime, the Job Bridge
and the scheduler use: ``spawn``, ``reap``, ``wait_quiet``,
``gather_bounded`` and ``retry``). The
reference's task-failure and retry counters and its flight-recorder
breadcrumbs belong to its telemetry, which is not ported (ROADMAP.md,
Queue 1: telemetry); a failed background task or a retried attempt is
logged here and nothing more.

``asyncio.gather(..., return_exceptions=True)`` is the primitive that makes
the cancellation semantics right: child outcomes become return values, but
cancellation delivered to the *waiter* still raises through the await.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Any, Awaitable, Callable, Coroutine, MutableSet, TypeVar

__all__ = ["spawn", "reap", "wait_quiet", "gather_bounded", "retry"]

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


_T = TypeVar("_T")


async def gather_bounded(
    fns: "list[Callable[[], Awaitable[_T]]]", *, limit: int = 8
) -> "list[_T]":
    """Run awaitable FACTORIES concurrently, at most ``limit`` in flight,
    returning results in input order.

    The scheduler's fan-out primitive (lease acceptance, dispatch): a
    serial ``for peer: await`` walk makes every control-plane sweep O(N)
    round trips, while an unbounded gather floods the fabric. Nothing is
    created until a slot frees. The first failure propagates after every
    sibling is cancelled and awaited (no orphaned in-flight requests).
    """
    if not fns:
        return []
    sem = asyncio.Semaphore(max(int(limit), 1))

    async def run(fn: "Callable[[], Awaitable[_T]]") -> "_T":
        async with sem:
            return await fn()

    tasks = [asyncio.create_task(run(fn)) for fn in fns]
    try:
        return await asyncio.gather(*tasks)
    finally:
        await reap(*(t for t in tasks if not t.done()))


async def retry(
    fn: Callable[[], Awaitable[_T]],
    *,
    attempts: int = 0,
    base_delay: float = 0.25,
    max_delay: float = 10.0,
    attempt_timeout: "float | None" = None,
    deadline: "float | None" = None,
    retry_on: "tuple[type[BaseException], ...]" = (Exception,),
    what: str = "",
    logger: "logging.Logger | None" = None,
) -> _T:
    """Call ``fn()`` until it succeeds, with jittered exponential backoff.

      * ``attempts``        — total tries; 0 = unbounded (the deadline is
        then the only stop);
      * ``attempt_timeout`` — wall-clock bound per try (``wait_for``
        semantics: the in-flight attempt is cancelled);
      * ``deadline``        — overall seconds budget from the first try;
        when it cannot fit another attempt, the last error re-raises;
      * ``retry_on``        — exception classes worth re-trying.
        ``CancelledError`` always propagates immediately.
    """
    loop = asyncio.get_running_loop()
    stop_at = None if deadline is None else loop.time() + deadline
    label = what or getattr(fn, "__qualname__", "operation")
    lg = logger or log
    # A per-attempt timeout is retryable regardless of ``retry_on``.
    catchable = tuple(retry_on) + (asyncio.TimeoutError,)
    attempt = 0
    while True:
        attempt += 1
        try:
            if attempt_timeout is None:
                return await fn()
            return await asyncio.wait_for(fn(), attempt_timeout)
        except asyncio.CancelledError:
            raise
        except catchable as e:
            out_of_attempts = attempts > 0 and attempt >= attempts
            delay = min(max_delay, base_delay * (2 ** (attempt - 1)))
            delay *= 0.5 + random.random()  # jitter: 0.5x..1.5x
            out_of_time = stop_at is not None and loop.time() + delay >= stop_at
            if out_of_attempts or out_of_time:
                lg.warning("retry %r: giving up after %d attempt(s): %s", label, attempt, e)
                raise
            lg.info("retry %r: attempt %d failed (%s); next in %.2fs", label, attempt, e, delay)
            await asyncio.sleep(delay)
