"""Paged KV-cache primitives for the caption engine (port of
``cosmos_curate_tpu/models/vlm/paged_kv.py``).

KV memory is ONE block pool ``[L, n_blocks, block_size, Hkv, Dh]`` and every
slot owns a block *table*, so a request's KV footprint is
``ceil(len / block_size)`` blocks (vLLM's PagedAttention, Kwon et al. 2023).
The pools are updated IN PLACE: where the reference returns new pools from
``.at[].set``, these functions write through ``index_put_``.

Two JAX semantics the port keeps on purpose:

- **Out-of-table writes are dropped.** A write position whose logical block
  lies past the row's table is a no-op (JAX's ``take_along_axis`` fills the
  block id with INT_MIN and the scatter drops the update);
  :func:`paged_write_plan` removes those positions instead of letting torch
  raise or wrap.
- **Duplicate scatter indices write identical values.** Shared-prefix
  blocks sit in many tables and pow2 row padding duplicates row 0, so a
  scatter may hit one cell several times; ``index_put_`` leaves the winner
  undefined, and the engine's copy-on-write invariant (a slot's own writes
  start at the prefix boundary) makes every such write identical. Block 0 is
  the reserved garbage block: free table entries point at it, idle decode
  rows write there, and it is never read unmasked.

The allocator is host-side and refcounted: the shared-prefix LRU holds one
reference per cached block, every admitted slot one per shared block it
maps; a block returns to the free list when the last reference drops.
"""

from __future__ import annotations

import torch


class PoolExhausted(RuntimeError):
    """The block pool cannot supply the requested allocation right now.

    Admission treats this as backpressure (the request waits for in-flight
    slots to free their blocks), not as an error."""


class BlockAllocator:
    """Refcounted free-list allocator over pool block ids.

    Block 0 is the reserved garbage block (never handed out). All mutation
    runs under the engine lock; the allocator itself is lock-free.
    """

    def __init__(self, n_blocks: int) -> None:
        if n_blocks < 2:
            raise ValueError(f"block pool needs >= 2 blocks, got {n_blocks}")
        self.n_blocks = n_blocks
        self._refs = [0] * n_blocks
        # LIFO free list: recently freed blocks are re-used first
        self._free = list(range(n_blocks - 1, 0, -1))

    @property
    def capacity(self) -> int:
        """Allocatable blocks (the garbage block is not)."""
        return self.n_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.capacity - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        """n fresh blocks with refcount 1; raises PoolExhausted when the
        free list cannot supply them (callers requeue and wait)."""
        if n > len(self._free):
            raise PoolExhausted(f"need {n} KV blocks, {len(self._free)} free of {self.capacity}")
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._refs[b] = 1
        return ids

    def incref(self, ids) -> None:
        for b in ids:
            if self._refs[b] <= 0:
                raise ValueError(f"incref on free block {b}")
            self._refs[b] += 1

    def decref(self, ids) -> list[int]:
        """Drop one reference per id; blocks reaching zero return to the
        free list. Returns the freed ids."""
        freed: list[int] = []
        for b in ids:
            r = self._refs[b]
            if r <= 0:
                raise ValueError(f"decref on free block {b}")
            self._refs[b] = r - 1
            if r == 1:
                self._free.append(b)
                freed.append(b)
        return freed

    def ref(self, block_id: int) -> int:
        return self._refs[block_id]


def init_block_pool(cfg, n_blocks: int, block_size: int, dtype=torch.bfloat16, device=None):
    """The K and V block pools: ``[L, n_blocks, block_size, Hkv, Dh]``."""
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def gather_block_views(pool_k, pool_v, tables):
    """Per-slot contiguous KV views (copies) through the block tables.

    pool_k/v: ``[L, NB, bs, Hkv, Dh]``; tables: ``[N, nbl]`` block ids.
    Returns ``[L, N, nbl * bs, Hkv, Dh]`` views."""
    l, _, bs = pool_k.shape[:3]
    n, nbl = tables.shape
    tables = tables.long()
    vk = pool_k[:, tables].reshape(l, n, nbl * bs, *pool_k.shape[3:])
    vv = pool_v[:, tables].reshape(l, n, nbl * bs, *pool_v.shape[3:])
    return vk, vv


def scatter_block_views(pool_k, pool_v, tables, view_k, view_v) -> None:
    """Write updated per-slot views back into the pool blocks, in place.
    Duplicate table entries write identical values (module docstring)."""
    l, _, bs = pool_k.shape[:3]
    n, nbl = tables.shape
    tables = tables.long()
    pool_k[:, tables] = view_k.reshape(l, n, nbl, bs, *view_k.shape[3:])
    pool_v[:, tables] = view_v.reshape(l, n, nbl, bs, *view_v.shape[3:])


def paged_write_plan(tables, write_index, t: int, block_size: int):
    """Where a T-token chunk lands in one layer's pool, flattened to
    ``[NB * bs]`` rows: (pool rows, chunk rows kept). Chunk row
    ``b * T + i`` writes logical position ``write_index[b] + i`` through
    ``tables[b]``; positions past the table are dropped (JAX scatter
    semantics). The plan is the same for every layer, so a forward builds it
    once; building it reads the kept count back to the host."""
    nbl = tables.shape[1]
    pos = write_index.long()[:, None] + torch.arange(t, device=tables.device)[None, :]
    logical = pos // block_size
    ok = (pos >= 0) & (logical < nbl)
    blk = torch.gather(tables.long(), 1, logical.clamp(0, nbl - 1))
    rows = (blk * block_size + pos.remainder(block_size)).reshape(-1)
    keep = ok.reshape(-1).nonzero().squeeze(1)
    return rows[keep], keep


def paged_update(pool_k, pool_v, k, v, plan, *, layer_index: int) -> None:
    """Scatter a chunk's K/V ``[B, T, Hkv, Dh]`` into layer ``layer_index``
    of the pools, in place, following :func:`paged_write_plan`."""
    rows, keep = plan
    _, nb, bs, hk, d = pool_k.shape
    for pool, x in ((pool_k, k), (pool_v, v)):
        flat = pool[layer_index].view(nb * bs, hk, d)
        flat.index_put_((rows,), x.reshape(-1, hk, d)[keep].to(pool.dtype))
