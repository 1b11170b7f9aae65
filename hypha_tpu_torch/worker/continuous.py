"""Serving adapter for the decode pool (counterpart of
``hypha_tpu/worker/continuous.py``): greedy requests that fit go into the
:class:`~hypha_tpu_torch.executor.pool.DecodePool`; sampled and oversized
requests take the bounded one-shot fallback. ``weight_state``,
``request_swap`` and ``pin_round`` pass through to the pool's live weight
swap (reference ``:106-135``)."""

from __future__ import annotations

import asyncio
from typing import Any, Callable

from ..executor.pool import DecodePool, PoolBusy

__all__ = ["PoolServer"]


class PoolServer:
    """``submit``/``close`` over a DecodePool.

    ``run_fallback(prompts, n_new, temperature, top_k, seed) ->
    list[list[int]]`` is the blocking one-shot generation used for sampled
    and oversized requests; at most ``fallback_concurrency`` run at once,
    in worker threads. ``pool_options`` go to :class:`DecodePool`."""

    def __init__(
        self,
        model,
        run_fallback: Callable[..., list],
        *,
        slots: int,
        max_len: int,
        fallback_concurrency: int = 2,
        **pool_options: Any,
    ) -> None:
        self.pool = DecodePool(model, slots=slots, max_len=max_len, **pool_options)
        self.fleet_cache = self.pool.fleet_cache
        self._run_fallback = run_fallback
        self._fallback_sem = asyncio.Semaphore(max(int(fallback_concurrency), 1))
        self._closed = False
        self.requests = 0
        self.fallbacks = 0  # sampled + oversized-greedy one-shot decodes
        self.rejections = 0  # PoolBusy backpressure rejections

    @property
    def chunks(self) -> int:
        return self.pool.chunks

    def load(self) -> dict:
        """Admission headroom, as the JAX server reports it on ``ServeLoad``
        heartbeats, with the serving (round, generation): ``None`` until
        the first swap, so a server that follows nothing keeps them off
        the wire. With the fleet cache on,
        ``cache_digest`` is the pool's top-K hot chains (``None`` while it
        is empty); off, the key is absent and the heartbeat unchanged."""
        weight_round, weight_generation = self.pool.weight_state()
        out = {
            "queue_depth": self.pool.queue_depth(),
            "free_blocks": self.pool.free_blocks(),
            "live_requests": self.pool.live_rows(),
            "requests": self.requests,
            "rejections": self.rejections,
            "weight_round": weight_round,
            "weight_generation": weight_generation,
        }
        if self.fleet_cache:
            out["cache_digest"] = self.pool.fleet_digest or None
        return out

    def weight_state(self) -> tuple:
        """The (round, generation) being served; ``(None, None)`` before the
        first swap."""
        return self.pool.weight_state()

    def request_swap(self, updates: dict, **kw: Any) -> None:
        """Stage an update for the pool's next flip (``DecodePool.request_swap``)."""
        self.pool.request_swap(updates, **kw)

    def pin_round(self, round_num: "int | None") -> None:
        """Pin serving to a round, or lift the pin (``DecodePool.pin_round``)."""
        self.pool.pin_round(round_num)

    async def submit(
        self, prompts: list, n_new: int, temperature: float, top_k: "int | None", seed: int,
        traceparent: "str | None" = None,
    ) -> list:
        if self._closed:
            raise RuntimeError("server is closed")
        self.requests += 1
        if temperature == 0.0 and self.pool.fits(prompts, n_new):
            try:
                # ``traceparent`` parents the pool's prefill and decode
                # spans under the request's trace.
                return await asyncio.wrap_future(
                    self.pool.submit([list(p) for p in prompts], n_new, traceparent=traceparent)
                )
            except PoolBusy:
                # Backpressure surfaces to the caller; the fallback is for
                # shape misfits, not load.
                self.rejections += 1
                raise
        self.fallbacks += 1
        async with self._fallback_sem:
            return await asyncio.to_thread(
                self._run_fallback, prompts, n_new, temperature, top_k, seed
            )

    def close(self) -> None:
        self._closed = True
        self.pool.close(wait=False)
