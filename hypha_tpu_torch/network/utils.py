"""Fabric utilities (a copy of ``hypha_tpu/network/utils.py``).

``batched`` mirrors the reference's ``Batched<S>`` stream adapter — window an
async stream by *count limit OR time window*, whichever trips first
(reference: crates/network/src/utils.rs:50-110; used to window auction
requests, crates/worker/src/arbiter.rs:89-93).
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator

__all__ = ["batched"]


async def batched(
    source: AsyncIterator[Any], limit: int, window_s: float
) -> AsyncIterator[list[Any]]:
    """Yield non-empty batches: up to ``limit`` items or whatever arrived
    within ``window_s`` of the batch's first item. Ends when the source ends.

    The pending ``anext`` is kept alive across window boundaries — a
    ``wait_for``-style cancel would tear down the source generator itself
    and silently end the stream after the first quiet window.
    """
    pending: asyncio.Task | None = None
    try:
        while True:
            if pending is None:
                pending = asyncio.ensure_future(anext(source))
            try:
                first = await pending
            except StopAsyncIteration:
                pending = None
                return
            pending = None
            batch = [first]
            deadline = asyncio.get_running_loop().time() + window_s
            while len(batch) < limit:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                if pending is None:
                    pending = asyncio.ensure_future(anext(source))
                done, _ = await asyncio.wait({pending}, timeout=remaining)
                if not done:
                    break  # window closed; keep the read pending for later
                task, pending = pending, None
                try:
                    batch.append(task.result())
                except StopAsyncIteration:
                    yield batch
                    return
            yield batch
    finally:
        if pending is not None:
            pending.cancel()
