"""KV cache for decode forwards (counterpart of ``hypha_tpu/ops/kvcache.py``).

The JAX package keeps the cache in flax's mutable ``"cache"`` collection,
one set of variables per layer. Here it is an explicit :class:`KVCache`
object handed to ``Llama.forward``: per-layer K/V tensors plus ONE set of
row variables (``idx``, ``start``, ``table``) shared by every layer — the
JAX layers all hold identical copies of those, so one copy is the same
state. The model reads ``idx`` before its layers run and calls
:meth:`KVCache.advance` after.

Three modes, as in the reference:

* **scalar** (``generate``): one write index shared by every row;
* **per-row** (``per_row=True``): each row has its own index and left-pad
  ``start``; writes past the window are dropped;
* **paged** (``blocks > 0``): K/V live in a pool of ``blocks`` physical
  blocks of ``block_size`` positions plus one garbage block (id
  ``blocks``), laid out exactly ``[(blocks + 1) * block_size, Hkv, D]``
  (int8 scales ``[(blocks + 1) * block_size, Hkv]`` f32), addressed
  through a per-lane ``table``. Positions not backed by an allocated block
  — idle lanes parked at ``idx >= decode_len``, sentinel table entries —
  resolve to the garbage block, so such writes land where nothing reads
  them meaningfully.

The pool tensors are updated in place (the JAX package returns new
arrays); the pool host overwrites ``idx``/``start``/``table`` in place
before every dispatch.

The fleet prefix cache and KV migration ship whole blocks between pools
(``extract_blocks`` / ``insert_blocks``), keyed by the JAX cache's tree
paths (``"['layers_{i}']['self_attn']['k']"``, ``'v'``, ``'k_scale'``,
``'v_scale'``) and in its order, so a JAX pool and a port pool land each
other's blocks; ``leaves_to_wire`` / ``leaves_from_wire`` carry them as
``[raw bytes, dtype name, shape]`` with the JAX package's dtype names.
"""

from __future__ import annotations

import torch

__all__ = [
    "KVCache", "KV_QMAX", "copy_blocks", "extract_blocks", "insert_blocks", "pool_leaves",
    "leaves_to_wire", "leaves_from_wire", "leaves_nbytes",
]

# int8 KV rows: payload in [-127, 127], scale = maxabs / 127; zero or
# non-finite rows store an all-zero payload with a zero scale.
KV_QMAX = 127.0


# The pool tensors a block copy moves: the K/V payloads and, in int8 mode,
# their per-row scales, which are laid out row-parallel to the payloads.
_POOL_LEAVES = ("k", "v", "k_scale", "v_scale")
# Wire dtype names (numpy's, as the JAX package writes them) and back.
_WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8"}
_FROM_WIRE = {name: dtype for dtype, name in _WIRE_DTYPES.items()}


def _quantize_rows(x: torch.Tensor) -> tuple:
    """Max-abs int8 quantization over the head_dim axis, one scale per
    (position, kv-head): ``x`` [N, Hkv, D] -> (int8 [N, Hkv, D], f32
    [N, Hkv]). Rounds half to even, like ``jnp.rint``."""
    xf = x.float()
    maxabs = xf.abs().amax(dim=-1)
    ok = torch.isfinite(maxabs) & (maxabs > 0)
    scale = torch.where(ok, maxabs / KV_QMAX, 0.0)
    inv = torch.where(ok, KV_QMAX / torch.where(ok, maxabs, 1.0), 0.0)
    q = torch.clamp(torch.round(xf * inv[..., None]), -KV_QMAX, KV_QMAX)
    # A non-finite row would turn into NaN * 0 here: store exact zeros.
    payload = torch.where(ok[..., None], q, 0.0).to(torch.int8)
    return payload, scale


def _physical(table, cols, block_size: int, max_blocks: int, blocks: int):
    """Map logical window positions ``cols`` [B, S] to physical pool rows
    through ``table`` [B, max_blocks]. Out-of-window positions map into
    the garbage block ``blocks``; ids are clamped into [0, blocks]."""
    bi = torch.div(cols, block_size, rounding_mode="floor")
    safe = torch.clamp(bi, 0, max_blocks - 1)
    blk = torch.gather(table, 1, safe.to(torch.int64))
    blk = torch.where((cols >= 0) & (bi < max_blocks), blk, blocks)
    blk = torch.clamp(blk, 0, blocks)
    return blk * block_size + torch.remainder(cols, block_size)


class KVCache:
    """Decode-time K/V state for every layer of one model.

    ``update(layer, k, v, offset)`` writes this step's RoPE'd K/V
    ([B, S, Hkv, D]) at ``offset`` and returns what attention reads: the
    dense per-row views ``(full_k, full_v)``, or, in ragged paged mode, the
    raw pool view ``(PagedKV, None)`` that ``ops.paged_attention`` walks
    through the block table."""

    def __init__(
        self,
        *,
        num_layers: int,
        batch: int,
        decode_len: int,
        num_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype,
        device: "torch.device | str",
        per_row: bool = False,
        blocks: int = 0,
        block_size: int = 0,
        kv_quant: str = "",
        ragged: bool = False,
    ) -> None:
        if (kv_quant or ragged) and blocks <= 0:
            raise ValueError("kv_quant / ragged require paged mode (blocks > 0)")
        if kv_quant not in ("", "int8"):
            raise ValueError(f"unsupported kv_quant {kv_quant!r} ('' | 'int8')")
        B, L, H, D = batch, decode_len, num_kv_heads, head_dim
        self.batch, self.decode_len = B, L
        self.per_row = bool(per_row) or blocks > 0
        self.blocks, self.block_size = int(blocks), int(block_size)
        self.kv_quant, self.ragged = kv_quant, bool(ragged)
        self.k_scale = self.v_scale = None
        self.start = self.table = None
        dev = torch.device(device)
        if blocks > 0:
            if not per_row:
                raise ValueError("paged KV cache requires per_row=True")
            if block_size <= 0 or L % block_size != 0:
                raise ValueError(
                    f"decode_len {L} must be a positive multiple of "
                    f"block_size {block_size}"
                )
            self.max_blocks = L // block_size
            rows = (blocks + 1) * block_size
            pool_dtype = torch.int8 if kv_quant == "int8" else dtype
            self.idx = torch.zeros((B,), dtype=torch.int32, device=dev)
            self.start = torch.zeros((B,), dtype=torch.int32, device=dev)
            # Unallocated entries hold the garbage-block sentinel, so a
            # fresh table never aliases a real block.
            self.table = torch.full((B, self.max_blocks), blocks, dtype=torch.int32, device=dev)
            shape = (rows, H, D)
            self.k = [torch.zeros(shape, dtype=pool_dtype, device=dev) for _ in range(num_layers)]
            self.v = [torch.zeros(shape, dtype=pool_dtype, device=dev) for _ in range(num_layers)]
            if kv_quant == "int8":
                self.k_scale = [torch.zeros((rows, H), device=dev) for _ in range(num_layers)]
                self.v_scale = [torch.zeros((rows, H), device=dev) for _ in range(num_layers)]
            return
        shape = (B, L, H, D)
        self.k = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(num_layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(num_layers)]
        if self.per_row:
            self.idx = torch.zeros((B,), dtype=torch.int32, device=dev)
            self.start = torch.zeros((B,), dtype=torch.int32, device=dev)
        else:
            self.idx = 0

    @classmethod
    def for_model(cls, model, batch: int, decode_len: int, **kw) -> "KVCache":
        """A cache shaped for ``model`` (a ``models.llama.Llama``) in its
        compute dtype, on the device its weights live on."""
        cfg = model.config
        return cls(
            num_layers=cfg.num_layers, batch=batch, decode_len=decode_len,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            dtype=getattr(torch, cfg.dtype), device=model.device, **kw,
        )

    def advance(self, steps: int) -> None:
        """Move every row's write index past this forward's positions."""
        if self.per_row:
            self.idx.add_(steps)
        else:
            self.idx += steps

    def update(self, layer: int, k: torch.Tensor, v: torch.Tensor, offset):
        B, S, H, D = k.shape
        ck, cv = self.k[layer], self.v[layer]
        if self.blocks > 0:
            bs, blocks = self.block_size, self.blocks
            cols = offset[:, None] + torch.arange(S, device=k.device)[None, :]
            phys = _physical(self.table, cols, bs, self.max_blocks, blocks).reshape(-1)
            kw, vw = k.reshape(B * S, H, D), v.reshape(B * S, H, D)
            if self.kv_quant == "int8":
                kw, k_sc = _quantize_rows(kw)
                vw, v_sc = _quantize_rows(vw)
                self.k_scale[layer][phys] = k_sc
                self.v_scale[layer][phys] = v_sc
            ck[phys] = kw
            cv[phys] = vw
            ks = None if self.k_scale is None else self.k_scale[layer]
            vs = None if self.v_scale is None else self.v_scale[layer]
            if self.ragged:
                from .paged_attention import PagedKV

                return PagedKV(k=ck, v=cv, k_scale=ks, v_scale=vs, table=self.table), None
            L = self.decode_len
            win = torch.arange(L, device=k.device)[None, :].expand(B, L)
            phys_win = _physical(self.table, win, bs, self.max_blocks, blocks)
            full_k, full_v = ck[phys_win], cv[phys_win]
            if self.kv_quant == "int8":
                full_k = (full_k.float() * ks[phys_win][..., None]).to(k.dtype)
                full_v = (full_v.float() * vs[phys_win][..., None]).to(k.dtype)
            return full_k, full_v
        if self.per_row:
            cols = offset[:, None] + torch.arange(S, device=k.device)[None, :]
            rows = torch.arange(B, device=k.device)[:, None].expand(B, S)
            # Writes past the window are dropped, as XLA's mode="drop"
            # scatter does: a released row decoding on can never corrupt
            # a live one.
            keep = (cols >= 0) & (cols < self.decode_len)
            ck[rows[keep], cols[keep]] = k[keep]
            cv[rows[keep], cols[keep]] = v[keep]
            return ck, cv
        # dynamic_update_slice semantics: the start clamps so S fits.
        o = max(min(int(offset), self.decode_len - S), 0)
        ck[:, o : o + S] = k
        cv[:, o : o + S] = v
        return ck, cv


def copy_blocks(cache: KVCache, src, dst, block_size: int) -> KVCache:
    """Copy whole physical blocks ``src -> dst`` in every layer's paged
    pool tensors, scales included (copy-on-write: a lane about to write
    into a block that other lanes share gets a private copy first). The
    row variables are the pool host's and stay as they are. In place, on
    the cache's device; returns ``cache``.

    Counterpart of ``hypha_tpu/ops/kvcache.py`` ``copy_blocks``, which XLA
    compiles from ``.at[rows].set``: an indexed copy, not a kernel."""
    if cache.blocks <= 0:
        raise ValueError("copy_blocks needs a paged KV cache")
    dev = cache.k[0].device
    offs = torch.arange(block_size, device=dev)
    rows = {}
    for name, ids in (("src", src), ("dst", dst)):
        ids = torch.as_tensor(ids, dtype=torch.int64, device=dev).reshape(-1)
        rows[name] = (ids[:, None] * block_size + offs[None, :]).reshape(-1)
    for name in _POOL_LEAVES:
        for leaf in getattr(cache, name) or ():
            leaf[rows["dst"]] = leaf[rows["src"]]
    return cache


def _block_rows(ids, block_size: int, device) -> torch.Tensor:
    ids = torch.as_tensor(list(ids), dtype=torch.int64, device=device).reshape(-1)
    return (ids[:, None] * block_size + torch.arange(block_size, device=device)[None, :]).reshape(-1)


def pool_leaves(cache: KVCache) -> dict:
    """``{tree path: pool tensor}`` of every paged pool leaf, in the
    order the JAX package walks its cache tree (sorted paths)."""
    found = {}
    for name in _POOL_LEAVES:
        for layer, leaf in enumerate(getattr(cache, name) or ()):
            found[f"['layers_{layer}']['self_attn']['{name}']"] = leaf
    return dict(sorted(found.items()))


def extract_blocks(cache: KVCache, ids, block_size: int) -> dict:
    """Gather whole physical blocks ``ids`` (root first) out of every pool
    leaf as host tensors: ``{tree path: rows}``, ``len(ids) * block_size``
    rows each in chain order, int8 payloads with their scale rows.
    Counterpart of the JAX ``extract_blocks`` (an indexed copy)."""
    rows = _block_rows(ids, block_size, cache.k[0].device)
    return {key: leaf[rows].cpu() for key, leaf in pool_leaves(cache).items()}


def insert_blocks(cache: KVCache, ids, leaves: dict, block_size: int) -> KVCache:
    """Scatter shipped rows (``extract_blocks``' layout) into the pool
    leaves at physical blocks ``ids``, cast to each leaf's dtype. A leaf
    that is missing on either side is skipped, as in the JAX package. In
    place; returns ``cache``."""
    rows = _block_rows(ids, block_size, cache.k[0].device)
    for key, leaf in pool_leaves(cache).items():
        data = leaves.get(key)
        if data is not None:
            leaf[rows] = torch.as_tensor(data).to(device=leaf.device, dtype=leaf.dtype)
    return cache


def leaves_to_wire(leaves: dict) -> dict:
    """``{tree path: [raw bytes, dtype name, shape]}`` for ``BlockChain`` /
    ``MigrateRequest``: the rows' bytes verbatim."""
    out = {}
    for key, t in leaves.items():
        t = t.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        out[key] = [raw, _WIRE_DTYPES[t.dtype], list(t.shape)]
    return out


def leaves_from_wire(wire: dict) -> dict:
    """The inverse of :func:`leaves_to_wire`, as host tensors. bf16 bytes
    decode through torch (numpy has no bf16)."""
    out = {}
    for key, (raw, dtype, shape) in wire.items():
        dt = _FROM_WIRE[dtype]
        if not raw:
            out[key] = torch.empty(shape, dtype=dt)
            continue
        out[key] = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(dt).reshape(shape)
    return out


def leaves_nbytes(leaves: dict) -> int:
    """Payload bytes of a leaf dict (the transfer-vs-recompute policy's
    byte count)."""
    return int(sum(t.numel() * t.element_size() for t in leaves.values()))
