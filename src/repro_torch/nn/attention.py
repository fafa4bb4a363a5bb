"""Grouped-query attention with RoPE over the paged KV layout
(counterpart of ``repro.nn.attention``; the paged serving paths only).

Each serving path takes a kernel knob, as in JAX (where the kernel is
``"pallas"``): ``"reference"`` gathers the slot's logical lane from the
pool and runs masked attention over it; ``"cuda"`` hands the attention to
the kernel wrapper (``repro_torch.kernels.paged_attention.paged_attention``
at decode, ``repro_torch.kernels.chunk_attention.chunk_attention`` for a
prefill chunk), which launches the CUDA kernel for a tensor on the card and runs
its plain version for a CPU tensor.

The projections are ``Linear`` modules, so ``auto_fact`` turns them into
``LED`` layers transparently.

The JAX package's scatters use ``mode="drop"`` and its gathers clip.  Torch
indexing does neither (it raises on the CPU and asserts on the card), so
both are carried over explicitly here: rows routed to the sentinel are
masked out before a write, and gathered row ids are clamped into the pool
(those lanes are masked to ``NEG_INF`` and weigh exactly zero).

The pool is written in place: ``PagedKVCache.k``/``v`` are views into the
model's layer-stacked pools, so a chunk or decode step updates them without
copying the pool.  Lengths are returned as new tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels._paged import NEG_INF
from repro_torch.kernels.chunk_attention import chunk_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.nn.linear import Linear
from repro_torch.nn.rotary import apply_rope

KERNELS = ("reference", "cuda")


def check_kernel(knob: str, value: str) -> None:
    """Raise ``ValueError`` for a ``decode_kernel``/``prefill_kernel`` name
    other than those in ``KERNELS``."""
    if value not in KERNELS:
        raise ValueError(f"unknown {knob} {value!r}; expected one of "
                         f"{KERNELS}")


class UnsupportedCacheError(ValueError):
    """A model/config's cache family cannot back the requested cache layout
    or serving mode.  ``roadmap_item`` names the ROADMAP entry that would
    lift the limitation."""

    def __init__(self, message: str, *, roadmap_item: Optional[str] = None):
        if roadmap_item:
            message = f"{message} [ROADMAP: {roadmap_item}]"
        super().__init__(message)
        self.roadmap_item = roadmap_item


class PagedKVCache(NamedTuple):
    """Paged (block-table) KV layout for continuous batching.

    All slots share one pool of fixed-size blocks; a per-slot block table
    maps logical position ``p`` to pool row ``table[slot, p // bs] * bs +
    p % bs``.  Table entries equal to ``n_blocks`` are the unmapped
    sentinel.  Built by ``TransformerLM.init_paged_cache``, which stacks a
    leading layer dim onto k/v/length."""

    k: torch.Tensor       # (n_blocks, block_size, kv_heads, head_dim)
    v: torch.Tensor       # (n_blocks, block_size, kv_heads, head_dim)
    table: torch.Tensor   # (batch, max_blocks_per_seq) int32 pool block ids
    length: torch.Tensor  # (batch,) int32 — valid positions per slot


def _scatter_rows(pool: torch.Tensor, rows: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """``pool[rows] = vals`` dropping rows ``>= len(pool)`` (JAX's
    ``.at[rows].set(vals, mode="drop")``)."""
    keep = rows < pool.shape[0]
    pool[rows[keep].long()] = vals[keep].to(pool.dtype)


class Attention(nn.Module):
    def __init__(self, q_proj: nn.Module, k_proj: nn.Module,
                 v_proj: nn.Module, o_proj: nn.Module, *, num_heads: int,
                 num_kv_heads: int, head_dim: int,
                 rope_theta: float = 10000.0):
        super().__init__()
        self.q_proj = q_proj
        self.k_proj = k_proj
        self.v_proj = v_proj
        self.o_proj = o_proj
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta

    @staticmethod
    def create(gen: torch.Generator, dim: int, num_heads: int,
               num_kv_heads: int, *, head_dim: Optional[int] = None,
               qkv_bias: bool = False, rope_theta: float = 10000.0,
               dtype=torch.float32) -> "Attention":
        head_dim = head_dim or dim // num_heads
        return Attention(
            q_proj=Linear.create(gen, dim, num_heads * head_dim,
                                 use_bias=qkv_bias, dtype=dtype),
            k_proj=Linear.create(gen, dim, num_kv_heads * head_dim,
                                 use_bias=qkv_bias, dtype=dtype),
            v_proj=Linear.create(gen, dim, num_kv_heads * head_dim,
                                 use_bias=qkv_bias, dtype=dtype),
            o_proj=Linear.create(gen, num_heads * head_dim, dim, dtype=dtype),
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            head_dim=head_dim, rope_theta=rope_theta)

    # -- helpers ------------------------------------------------------------

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """Projections + RoPE at ``positions`` (b, s) for queries and keys."""
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        q = apply_rope(q, positions, theta=self.rope_theta)
        k = apply_rope(k, positions, theta=self.rope_theta)
        return q, k, v

    def _attend(self, q, k, v, mask):
        """q: (b, sq, h, d); k/v: (b, sk, kvh, d); mask: (b, 1, sq, sk) bool.
        Products in the activation dtype, softmax in fp32."""
        group = self.num_heads // self.num_kv_heads
        b, sq, h, d = q.shape
        q = q.reshape(b, sq, self.num_kv_heads, group, d)
        logits = torch.einsum("bqkgd,bskd->bkgqs", q, k).float()
        logits = logits / math.sqrt(d)
        logits = logits.masked_fill(~mask[:, :, None, :, :], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
        return out.reshape(b, sq, h * d)

    def _gather_lanes(self, cache: PagedKVCache, table_rows: torch.Tensor,
                      dtype) -> tuple:
        """Gather each slot's logical lane ``(b, max_table*bs, kvh, hd)``
        from the pool through its block table rows ``(b, max_table)``.
        Sentinel entries clamp into the pool; the caller masks them."""
        nb, bs, kvh, hd = cache.k.shape
        kpos = torch.arange(table_rows.shape[1] * bs, device=cache.k.device)
        rows = (table_rows[:, kpos // bs].long() * bs + (kpos % bs)[None, :])
        rows = rows.clamp_(max=nb * bs - 1)
        pool_k = cache.k.reshape(nb * bs, kvh, hd)
        pool_v = cache.v.reshape(nb * bs, kvh, hd)
        return pool_k[rows].to(dtype), pool_v[rows].to(dtype), kpos

    # -- serving paths --------------------------------------------------------

    def prefill_chunk(self, x: torch.Tensor, cache: PagedKVCache, *,
                      slot: int, offset: int, n_valid: int,
                      dst: torch.Tensor, prefill_kernel: str = "reference"):
        """Consume one prompt chunk for ONE slot of the paged cache.

        ``x``: (1, W, dim), a bucket-padded span whose first ``n_valid``
        rows are real tokens starting at absolute position ``offset``.
        ``dst`` gives the flat pool row for each of the W positions; the
        engine points padding and cached-prefix positions at the sentinel
        row, and those writes drop.  ``prefill_kernel="reference"`` attends
        the slot's whole gathered lane (earlier chunks and shared prefix
        blocks) under a ``kpos <= qpos`` mask; ``"cuda"`` streams the
        resident prefix and the chunk's own K/V through the chunk kernel.
        Valid rows agree to float tolerance; padding rows carry no contract.

        Returns ``(chunk outputs (1, W, dim), cache)`` with the slot's
        length advanced to ``offset + n_valid``."""
        check_kernel("prefill_kernel", prefill_kernel)
        w = x.shape[1]
        qpos = offset + torch.arange(w, device=x.device)
        q, k, v = self._qkv(x, qpos[None, :])
        nb, bs, kvh, hd = cache.k.shape
        _scatter_rows(cache.k.view(nb * bs, kvh, hd), dst, k[0])
        _scatter_rows(cache.v.view(nb * bs, kvh, hd), dst, v[0])
        if prefill_kernel == "cuda":
            out = chunk_attention(
                q[0], cache.k, cache.v, cache.table[slot],
                k[0].to(cache.k.dtype), v[0].to(cache.v.dtype), offset,
                n_valid).reshape(1, w, -1)
        else:
            gk, gv, kpos = self._gather_lanes(cache, cache.table[slot][None],
                                              x.dtype)
            valid = kpos[None, :] <= qpos[:, None]  # (W, S)
            out = self._attend(q, gk, gv, valid[None, None])
        length = cache.length.clone()
        length[slot] = offset + n_valid
        return self.o_proj(out), cache._replace(length=length)

    def decode(self, x: torch.Tensor, cache: PagedKVCache,
               decode_kernel: str = "reference"):
        """Decode ``s`` tokens per slot against the shared block pool
        (``repro.nn.attention._decode_paged``).

        Each new K/V row goes to ``table[b, p // bs] * bs + p % bs`` for
        ``p = pos .. pos + s - 1``; slots whose table entry is the sentinel
        (finished, never admitted, or parked) write nowhere.  With
        ``decode_kernel="reference"`` every mapped pool row is then
        gathered back into logical order and masked ``kpos > qpos`` per
        query; with ``"cuda"`` and ``s == 1`` the paged-attention kernel
        reads the pool through the block table instead (multi-token steps
        keep the gather, as in JAX)."""
        check_kernel("decode_kernel", decode_kernel)
        b, s, _ = x.shape
        pos = cache.length  # (b,)
        qpos = pos[:, None].long() + torch.arange(s, device=x.device)[None]
        q, k, v = self._qkv(x, qpos)
        nb, bs, kvh, hd = cache.k.shape
        max_table = cache.table.shape[1]
        # a slot frozen at pos == max_table*bs would index one past the
        # table: clamp the lookup and route its write to the sentinel row
        blk = torch.gather(cache.table.long(), 1,
                           torch.clamp(qpos // bs, max=max_table - 1))
        row_new = torch.where(qpos < max_table * bs, blk * bs + qpos % bs,
                              torch.full_like(qpos, nb * bs))
        _scatter_rows(cache.k.view(nb * bs, kvh, hd), row_new, k)
        _scatter_rows(cache.v.view(nb * bs, kvh, hd), row_new, v)
        if decode_kernel == "cuda" and s == 1:
            out = paged_attention(q[:, 0], cache.k, cache.v, cache.table,
                                  pos).reshape(b, 1, -1)
        else:
            gk, gv, kpos = self._gather_lanes(cache, cache.table, x.dtype)
            valid = kpos[None, None, :] <= qpos[:, :, None]  # (b, s, S)
            out = self._attend(q, gk, gv, valid[:, None])
        return self.o_proj(out), cache._replace(length=pos + s)
