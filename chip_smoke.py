"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name, capability and power limit;
2. build   — compile every kernel from ``hypha_tpu_torch/ops/csrc``;
3. kernels — each kernel against its plain PyTorch version on the card
   (bf16 and int8 pools, MHA and GQA, decode and prefill-chunk shapes,
   poisoned garbage and unallocated blocks, an idle lane that must be
   exactly zero, a window with a k_start floor), then its time at the
   Llama-2-7B decode shape beside the plain version, one PyTorch library
   call computing the same function, and the card's bound;
4. serve   — full-width Llama-2-7B (seeded random weights, bf16) behind
   ``PoolServer`` -> paged, ragged ``DecodePool``: concurrent greedy
   requests through asyncio; every kernel must have launched on this path
   and the plain attention path never;
5. serve_int8 — the same pool with int8 KV blocks;
6. reference — the 7B decode forward (through the kernel) against the
   training forward (plain attention), and a tiny f32 Llama whose pool
   tokens must equal one-shot ``generate``.

Then the kernels line, the ``nvidia-smi`` name and power limit line, and
the result line. Any failure exits non-zero before the result line; with
no CUDA device it exits 2 at once.
"""

from __future__ import annotations

import asyncio
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 outside tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # unit-variance inputs; bf16 output rounding
KERNEL_SOURCE = "hypha_tpu_torch/ops/csrc/ragged_paged_attention.cu"
REPLACES = "hypha_tpu/ops/paged_attention.py:213"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *, reps: int = 5, iters: int = 20, warmup: int = 3) -> float:
    """Median per-call device time of ``fn`` over ``reps`` event-timed runs
    of ``iters`` calls each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


# ------------------------------------------------------------- kernel phase


def paged_case(gen, *, B, sq, hq, hkv, D, bs, max_blocks, blocks, occupancy, quant,
               dtype=torch.bfloat16, idle=(), poison=1e4):
    """A pool-valid paged state on the card: lane b holds ``occupancy[b]``
    disjoint blocks (prefix-packed), its queries end at its last occupied
    position; every block no lane holds (the garbage block included) is
    poisoned; ``idle`` lanes hold only sentinels."""
    from hypha_tpu_torch.ops.kvcache import _quantize_rows
    from hypha_tpu_torch.ops.paged_attention import PagedKV

    dev = torch.device("cuda")
    rows = (blocks + 1) * bs
    k = torch.randn((rows, hkv, D), generator=gen, device=dev)
    v = torch.randn((rows, hkv, D), generator=gen, device=dev)
    perm = torch.randperm(blocks, generator=gen, device=dev).tolist()
    table = torch.full((B, max_blocks), blocks, dtype=torch.int32)
    qoff = torch.zeros((B,), dtype=torch.int32)
    held = torch.zeros((blocks + 1,), dtype=torch.bool)
    for b in range(B):
        if b in idle:
            qoff[b] = max_blocks * bs
            continue
        ids = [perm.pop() for _ in range(occupancy[b])]
        table[b, : len(ids)] = torch.tensor(ids, dtype=torch.int32)
        held[ids] = True
        qoff[b] = max(occupancy[b] * bs - sq, 0)
    unreachable = (~held).repeat_interleave(bs).to(dev)
    k[unreachable] = poison
    v[unreachable] = poison
    if quant:
        (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
    else:
        k, v, ks, vs = k.to(dtype), v.to(dtype), None, None
    q = torch.randn((B, sq, hq, D), generator=gen, device=dev).to(dtype)
    kv = PagedKV(k, v, ks, vs, table.to(dev))
    return q, kv, qoff.to(dev), unreachable


def kernel_phase() -> dict:
    from hypha_tpu_torch.ops.paged_attention import ragged_block_attention, ragged_paged_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    bs, max_blocks, blocks = 16, 64, 512  # the 7B pool: max_len 1024, 512 blocks
    cases = []
    for hq, hkv in ((32, 32), (32, 8)):
        for sq in (1, 64):
            for quant in (False, True):
                cases.append(dict(hq=hq, hkv=hkv, sq=sq, quant=quant, window=None, k_start=None))
    cases.append(dict(hq=32, hkv=8, sq=64, quant=False, window=100, k_start=[0, 37, 5, 0]))
    results, max_err = [], 0.0
    for c in cases:
        occupancy = [9, 40, 0, 64]  # partial, partial, idle lane 2, full
        q, kv, qoff, unreachable = paged_case(
            gen, B=4, sq=c["sq"], hq=c["hq"], hkv=c["hkv"], D=128, bs=bs,
            max_blocks=max_blocks, blocks=blocks, occupancy=occupancy,
            quant=c["quant"], idle=(2,),
        )
        kst = None if c["k_start"] is None else torch.tensor(c["k_start"], dtype=torch.int32, device="cuda")
        kw = dict(blocks=blocks, block_size=bs, q_offset=qoff, k_start=kst, window=c["window"])
        got = ragged_paged_attention(q, kv, **kw)
        torch.cuda.synchronize()
        ref = ragged_block_attention(q, kv, **kw)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        idle_zero = bool(torch.all(got[2] == 0))
        # Re-poison everything no lane may read: the output bits must stay.
        kv.k[unreachable] = kv.k[unreachable] * -3 + 1
        kv.v[unreachable] = kv.v[unreachable] * 2 - 5
        again = ragged_paged_attention(q, kv, **kw)
        torch.cuda.synchronize()
        bit_invariant = bool(torch.equal(got, again))
        ok = err <= TOL[torch.bfloat16] and idle_zero and bit_invariant
        results.append(dict(c, max_abs_err=err, tol=TOL[torch.bfloat16], idle_zero=idle_zero,
                            poison_bit_invariant=bit_invariant, ok=ok))
        max_err = max(max_err, err)
        if not ok:
            emit({"phase": "kernels", "failed_case": results[-1]})
            raise SystemExit("kernel disagrees with its plain version")

    # Time at the 7B decode shape: 8 lanes, 1 query, 512 occupied positions.
    timing = {}
    for label, quant, sq, hkv in (("decode_bf16", False, 1, 32), ("decode_int8", True, 1, 32),
                                  ("decode_gqa8_bf16", False, 1, 8),
                                  ("prefill64_bf16", False, 64, 32)):
        B, hq, D = 8, 32, 128
        q, kv, qoff, _ = paged_case(
            gen, B=B, sq=sq, hq=hq, hkv=hkv, D=D, bs=bs, max_blocks=max_blocks,
            blocks=blocks, occupancy=[32] * B, quant=quant,
        )
        kw = dict(blocks=blocks, block_size=bs, q_offset=qoff)
        ms = time_ms(lambda: ragged_paged_attention(q, kv, **kw))
        plain_ms = time_ms(lambda: ragged_block_attention(q, kv, **kw), reps=3, iters=5)
        # Yardstick only: SDPA over the same keys gathered dense per lane.
        rows = (kv.table[:, :32].long()[:, :, None] * bs
                + torch.arange(bs, device="cuda")).reshape(B, 32 * bs)
        dense_k = (kv.k[rows].float() * (1 if kv.k_scale is None else kv.k_scale[rows][..., None]))
        dense_v = (kv.v[rows].float() * (1 if kv.v_scale is None else kv.v_scale[rows][..., None]))
        qh = q.transpose(1, 2).contiguous()
        kh = dense_k.to(q.dtype).transpose(1, 2).contiguous()
        vh = dense_v.to(q.dtype).transpose(1, 2).contiguous()
        keys = 32 * bs
        mask = None if sq == 1 else causal_tail(sq, keys)
        library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, enable_gqa=hq != hkv))
        kv_bytes = 2 * B * keys * hkv * D * kv.k.element_size()
        if quant:
            kv_bytes += 2 * B * keys * hkv * 4
        io_bytes = kv_bytes + 2 * q.numel() * q.element_size() + kv.table.numel() * 4 + 2 * B * 4
        ops = 4 * B * hq * sq * keys * D
        t_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[torch.bfloat16] * 1e3
        timing[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=max(t_bytes, t_ops),
                             bound_by="bytes" if t_bytes >= t_ops else "operations",
                             bytes=io_bytes, ops=ops, achieved_GBps=io_bytes / ms / 1e6)
    emit({"phase": "kernels", "cases": results, "timing": timing,
          "shape": "B=8 Hq=32 Hkv=32 (gqa8: 8) D=128 bs=16, 512 occupied positions per lane"})
    return {"max_abs_err": max_err, **timing["decode_bf16"]}


def causal_tail(sq: int, keys: int) -> torch.Tensor:
    """Bool mask for sq queries at the last sq of ``keys`` positions."""
    qi = torch.arange(keys - sq, keys, device="cuda")[:, None]
    return qi >= torch.arange(keys, device="cuda")[None, :]


# -------------------------------------------------------------- serve phase


def make_prompts(seed: int, lengths: list, vocab: int = 32_000) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(3, vocab, (n,), generator=g).tolist() for n in lengths]


async def drive(server, prompts: list, n_new: list) -> list:
    return await asyncio.gather(*(
        server.submit([p], n, 0.0, None, 0) for p, n in zip(prompts, n_new)
    ))


def serve_phase(model, *, kv_quant: str, lengths: list, n_new: list) -> dict:
    from hypha_tpu_torch.ops.paged_attention import paged_attention, ragged_paged_attention
    from hypha_tpu_torch.worker.continuous import PoolServer
    from hypha_tpu_torch.worker.infer_executor import generate_grouped

    def fallback(prompts, n, temperature, top_k, seed):
        return generate_grouped(model, prompts, n, temperature, top_k, seed)

    prompts = make_prompts(len(lengths) + len(kv_quant), lengths)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    async def run():
        server = PoolServer(model, fallback, slots=8, max_len=1024, steps_per_call=8,
                            block_size=16, ragged=True, kv_quant=kv_quant)
        try:
            ragged_paged_attention.launches = 0
            paged_attention.plain_calls = 0
            t0 = time.perf_counter()
            out = await drive(server, prompts, n_new)
            wall = time.perf_counter() - t0
            launches = ragged_paged_attention.launches
            plain = paged_attention.plain_calls
            stats = dict(server.pool.stats)
            again = await drive(server, prompts[:2], n_new[:2])
            return server, out, wall, launches, plain, stats, again
        finally:
            server.close()

    server, out, wall, launches, plain, stats, again = asyncio.run(run())
    for toks, n in zip(out, n_new):
        if len(toks) != 1 or len(toks[0]) != n:
            raise SystemExit(f"request answered with {len(toks[0])} tokens, wanted {n}")
    if again != out[:2]:
        raise SystemExit("a repeated request returned different tokens")
    if launches <= 0 or plain != 0:
        raise SystemExit(f"kernel launches {launches}, plain attention calls {plain}")
    if server.fallbacks:
        raise SystemExit("a request left the pool for the one-shot fallback")
    res = dict(
        kv_quant=kv_quant or "bf16", requests=len(prompts), prompt_lengths=lengths,
        n_new=n_new, wall_s=wall, kernel_launches=launches, plain_attention_calls=plain,
        decode_chunks=server.pool.chunks, prefill_chunks=server.pool.prefill_chunks,
        preemptions=server.pool.preemptions,
        prefill_tok_s=stats["prefill_tokens"] / stats["prefill_s"],
        decode_tok_s=stats["decode_tokens"] / stats["decode_s"],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        repeat_identical=True, **stats,
    )
    return res


def profile_phase(model) -> dict:
    """A steady decode step and a prefill chunk at the serving shape (8
    lanes, 512 cached positions each): host wall time per forward, and the
    device time the profiler sees, by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from hypha_tpu_torch.ops.kvcache import KVCache

    B, per_lane, n = 8, 32, 10
    out = {}
    for label, S in (("decode_step", 1), ("prefill_chunk", 64)):
        with torch.inference_mode():
            cache = KVCache.for_model(model, B, 1024, per_row=True, blocks=512, block_size=16,
                                      ragged=True)
            cache.table[:, : per_lane + 4] = torch.arange(
                B * (per_lane + 4), dtype=torch.int32, device="cuda").reshape(B, -1) % 512
            tok = torch.zeros((B, S), dtype=torch.int64, device="cuda")

            def forward():
                cache.idx.fill_(per_lane * 16 - S)
                return model(tok, cache)[:, -1].argmax(dim=-1)

            for _ in range(3):
                forward()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                forward()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / n * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    forward()
                torch.cuda.synchronize()
        # Device-side events only: CPU ops report their kernels' time too.
        rows = [(e.key, e.self_device_time_total / n / 1e3, e.count // n)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        attn = sum(ms for k, ms, _ in rows if "ragged_kernel" in k)
        out[label] = dict(wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
                          attention_kernel_ms=attn, kernels_per_forward=sum(r[2] for r in rows),
                          top=[{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:6]])
    return out


def reference_phase(model) -> dict:
    """The 7B decode forward through the kernel against the training
    forward, and a tiny f32 pool against one-shot generate."""
    from hypha_tpu_torch.executor.generate import generate
    from hypha_tpu_torch.executor.pool import DecodePool
    from hypha_tpu_torch.ops.kvcache import KVCache
    from hypha_tpu_torch.worker.infer_executor import load_model

    with torch.inference_mode():
        ids = torch.tensor(make_prompts(99, [64])[0], device="cuda")[None, :]
        dense = model(ids)
        cache = KVCache.for_model(model, 1, 1024, per_row=True, blocks=64, block_size=16, ragged=True)
        cache.table[0, :4] = torch.arange(4, dtype=torch.int32)
        paged = model(ids, cache)
    finite = bool(torch.isfinite(paged).all())
    err = (paged - dense).abs().max().item()
    scale = dense.abs().max().item()
    argmax_agree = (paged.argmax(-1) == dense.argmax(-1)).float().mean().item()

    # Tiny, but with the kernel's head_dim of 64 (4 query heads, 2 kv heads).
    tiny = load_model({"family": "llama", "preset": "tiny", "serve_dtype": "float32", "seed": 3,
                       "config": {"dtype": "float32", "hidden_size": 256}})
    prompts = make_prompts(5, [3, 17, 40], vocab=tiny.config.vocab_size)
    ref = [generate(tiny, [p], 20)[0].tolist() for p in prompts]
    pool = DecodePool(tiny, slots=4, max_len=128, steps_per_call=4, block_size=8,
                      num_blocks=12, prefill_chunk=16, reserve_blocks=1, ragged=True)
    try:
        got = [f.result(timeout=300)[0] for f in [pool.submit([p], 20) for p in prompts]]
    finally:
        pool.close()
    res = dict(llama7b_logits_max_abs_err=err, llama7b_logits_max_abs=scale,
               llama7b_argmax_agreement=argmax_agree, finite=finite,
               tiny_f32_pool_equals_generate=got == ref, tiny_preemptions=pool.preemptions)
    # Random-weight logits sit close together, so bf16 rounding in the
    # plain path (logits in bf16, then f32) flips some near-tied argmaxes:
    # 60 of 64 positions agreed, max error 2% of the largest logit, on the
    # first H100 run.
    if not finite or got != ref or argmax_agree < 0.75 or err > 0.05 * scale:
        emit({"phase": "reference", **res})
        raise SystemExit("the port disagrees with its reference")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hypha_tpu_torch.ops._build import build
    from hypha_tpu_torch.worker.infer_executor import load_model

    smi = nvidia_smi()
    t_start = time.perf_counter()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: {"seconds": v["seconds"], "cached": v["cached"],
                          "ptxas": [ln.strip() for ln in v["log"].splitlines() if "registers" in ln]}
                      for k, v in built.items()}})

    kern = kernel_phase()

    t0 = time.perf_counter()
    model = load_model({"family": "llama", "preset": "llama2-7b", "seed": 0})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    serve = serve_phase(model, kv_quant="", lengths=[17, 64, 130, 222, 333, 450, 599, 700],
                        n_new=[32, 40, 48, 56, 64, 36, 44, 60])
    emit({"phase": "serve", "model": "llama2-7b", "load_s": load_s, **serve})
    serve8 = serve_phase(model, kv_quant="int8", lengths=[25, 180, 410, 650], n_new=[32, 48, 40, 64])
    emit({"phase": "serve_int8", **serve8})
    emit({"phase": "profile", **profile_phase(model)})
    emit({"phase": "reference", **reference_phase(model)})

    emit({"kernels": [{
        "name": "ragged_paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": serve["kernel_launches"],
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
    }]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
