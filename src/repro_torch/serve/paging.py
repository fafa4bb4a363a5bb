"""Paged KV-cache management: block allocator, prefix cache, block tables.

Host-side bookkeeping for the paged KV layout (pure Python/numpy), a copy
of ``repro.serve.paging``.  The device side is a shared pool of
``n_blocks`` fixed-size KV blocks per layer
(:class:`repro_torch.nn.attention.PagedKVCache`); this module decides
which pool blocks each request owns:

* :class:`BlockAllocator` — free-list + per-block refcounts.  ``alloc``
  hands out an exclusively-owned block, ``fork`` adds a reader to a shared
  block, ``free`` drops one reference and returns the block to the free
  list when the count hits zero — unless the caller asks for
  ``recycle=False``, which *parks* the block instead: refcount zero, off
  the free list, content preserved.  ``adopt`` revives a parked block as
  exclusively owned again; ``reclaim`` pushes it onto the free list.
* :class:`PrefixCache` — hash-chained keys over *full* prompt blocks
  (``key_i = sha256(key_{i-1} || tokens[i*bs:(i+1)*bs])``) mapped to pool
  block ids, so requests sharing a system prompt reuse the same physical
  prefill blocks.  Only immutable full blocks are ever shared: a prompt's
  partial last block and all decode-time blocks are freshly allocated, so
  a cache hit can never alias a block that a live writer mutates
  (copy-on-extend by construction — extension always lands in a fresh
  block at a block boundary, no copy needed).
* :class:`PagedCacheManager` — ties both to per-slot block tables
  (``(batch, max_blocks_per_seq)`` int32, device sentinel ``n_blocks`` for
  unmapped entries so stale scatters drop and stale gathers clip into
  masked lanes) and to admission: a request reserves
  ``ceil(min(prompt_len + max_new, max_len) / block_size)`` blocks up
  front (minus prefix hits), so decode can never run out of blocks
  mid-request and FIFO admission defers — never skips — when the pool is
  exhausted.  Capacity is checked BEFORE any state mutates, so a refused
  admission leaves the allocator, tables, and prefix cache untouched.

Two chunked-prefill-era responsibilities live here as well:

* **Compute-aware prefix hits.**  ``admit`` returns how many leading
  prompt tokens are already *resident* in shared blocks; the engine then
  starts chunked prefill at that offset instead of recomputing the prefix
  (the pre-chunking engine shared the memory but re-ran the compute).
  Because shared blocks are registered at admission but only *written* as
  the owning prefill progresses, each admission also reports which hit
  blocks it depends on; ``blocks_ready`` gates a dependent prefill until
  its provider's chunks have covered them (``publish``), so a same-step
  prefix hit can never read a block before it holds real K/V.
* **LRU retention of freed prefix blocks.**  When the last reference to a
  prefix block drops, the block is parked on an LRU list (up to
  ``retain_blocks``) instead of recycled, keeping its K/V warm so a hit
  can survive an idle period with no live requests.  A new hit adopts the
  parked block (moving it back to refcounted life); pool pressure
  reclaims from the LRU tail, evicting the prefix entry with it.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


def chain_keys(tokens: np.ndarray, block_size: int) -> List[bytes]:
    """Hash-chained prefix keys, one per *full* block of ``tokens``.

    ``keys[i]`` commits to tokens ``[0, (i+1)*block_size)``, so equal keys
    imply equal full prefixes and a block is only ever hit together with
    every block before it."""
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
    keys, h = [], b""
    for i in range(len(tokens) // block_size):
        h = hashlib.sha256(
            h + tokens[i * block_size:(i + 1) * block_size].tobytes()).digest()
        keys.append(h)
    return keys


class BlockAllocator:
    """Refcounted free-list over a fixed pool of KV blocks."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1 or block_size < 1:
            raise ValueError("need n_blocks >= 1 and block_size >= 1")
        self.n_blocks, self.block_size = n_blocks, block_size
        self._free = list(range(n_blocks - 1, -1, -1))  # stack; pops 0,1,2,..
        self._parked: Set[int] = set()  # refcount 0, off the free list
        self.refcount = np.zeros(n_blocks, np.int32)
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_parked(self) -> int:
        return len(self._parked)

    @property
    def n_in_use(self) -> int:
        """Blocks some live request references (parked blocks excluded —
        they hold reclaimable warm content, not live tokens)."""
        return self.n_blocks - len(self._free) - len(self._parked)

    def alloc(self) -> int:
        """Take an exclusively-owned block (refcount 1) off the free list."""
        if not self._free:
            raise RuntimeError("out of KV blocks")
        bid = self._free.pop()
        self.refcount[bid] = 1
        self.peak_in_use = max(self.peak_in_use, self.n_in_use)
        return bid

    def fork(self, bid: int) -> None:
        """Add a reader to a live block (prefix sharing)."""
        if self.refcount[bid] <= 0:
            raise RuntimeError(f"fork of free block {bid}")
        self.refcount[bid] += 1

    def free(self, bid: int, *, recycle: bool = True) -> int:
        """Drop one reference; returns the remaining count.  At zero the
        block is recycled onto the free list, or — with ``recycle=False``
        — parked: content preserved, eligible for ``adopt``/``reclaim``."""
        if self.refcount[bid] <= 0:
            raise RuntimeError(f"double free of block {bid}")
        self.refcount[bid] -= 1
        rc = int(self.refcount[bid])
        if rc == 0:
            if recycle:
                self._free.append(bid)
            else:
                self._parked.add(bid)
        return rc

    def adopt(self, bid: int) -> None:
        """Revive a parked block as exclusively owned (prefix-hit on a
        retained block)."""
        if bid not in self._parked:
            raise RuntimeError(f"adopt of non-parked block {bid}")
        self._parked.discard(bid)
        self.refcount[bid] = 1
        self.peak_in_use = max(self.peak_in_use, self.n_in_use)

    def reclaim(self, bid: int) -> None:
        """Push a parked block onto the free list (LRU eviction)."""
        if bid not in self._parked:
            raise RuntimeError(f"reclaim of non-parked block {bid}")
        self._parked.discard(bid)
        self._free.append(bid)


class PrefixCache:
    """chain-key -> block id map with reverse lookup for eviction."""

    def __init__(self):
        self._by_key: Dict[bytes, int] = {}
        self._by_block: Dict[int, bytes] = {}

    def __len__(self) -> int:
        return len(self._by_key)

    def get(self, key: bytes) -> Optional[int]:
        return self._by_key.get(key)

    def put(self, key: bytes, bid: int) -> None:
        """Callers must evict any previous holder of ``key`` first (see
        the chain-broken-duplicate handling in ``PagedCacheManager.admit``
        — the one place that can re-register a live key)."""
        assert self._by_key.get(key) in (None, bid), "key already held"
        self._by_key[key] = bid
        self._by_block[bid] = key

    def has_block(self, bid: int) -> bool:
        return bid in self._by_block

    def drop_block(self, bid: int) -> None:
        """Evict the entry for a block returning to the free list."""
        key = self._by_block.pop(bid, None)
        if key is not None:
            del self._by_key[key]


class PagedCacheManager:
    """Block tables + reservation-based admission over one allocator.

    Owns the host mirror of the per-slot block tables the decode step
    gathers through; the engine re-uploads it whenever a slot is admitted
    or released.  ``retain_blocks`` bounds the LRU of parked prefix blocks
    (0 disables retention: freed prefix blocks recycle immediately, the
    pre-retention behaviour); ``prefix_reuse=False`` disables prefix
    sharing entirely — every admission allocates and computes its whole
    prompt (the baseline the prefix-skip benchmark compares against)."""

    def __init__(self, *, n_blocks: int, block_size: int, batch: int,
                 max_len: int, retain_blocks: int = 0,
                 prefix_reuse: bool = True):
        if retain_blocks < 0:
            raise ValueError("need retain_blocks >= 0")
        self.allocator = BlockAllocator(n_blocks, block_size)
        self.prefix = PrefixCache()
        self.block_size = block_size
        self.max_table = -(-max_len // block_size)
        self.sentinel = n_blocks  # out-of-range block id => unmapped
        self.tables = np.full((batch, self.max_table), self.sentinel,
                              np.int32)
        self._owned: Dict[int, List[int]] = {}  # slot -> owned block ids
        self.prefix_reuse = prefix_reuse
        self.retain_blocks = retain_blocks
        self.retained: "OrderedDict[int, None]" = OrderedDict()  # LRU parked
        self._pending: Set[int] = set()  # registered but not yet written
        self.prefix_hit_tokens = 0  # prompt tokens served from shared blocks

    def blocks_needed(self, total_tokens: int) -> int:
        return -(-total_tokens // self.block_size)

    def _plan(self, prompt: np.ndarray, total_tokens: int
              ) -> Tuple[List[bytes], List[int], int]:
        """(chain keys over full prompt blocks, longest-cached-chain block
        ids, #blocks the reservation needs)."""
        keys = chain_keys(prompt, self.block_size)
        hit_bids: List[int] = []
        if self.prefix_reuse:
            for k in keys:
                bid = self.prefix.get(k)
                if bid is None:
                    break
                hit_bids.append(bid)
        return keys, hit_bids, self.blocks_needed(total_tokens)

    def _fits(self, hit_bids: List[int], n_need: int) -> bool:
        """The ONE capacity formula both can_admit and admit consult:
        fresh blocks needed vs free list + parked blocks this admission
        would not itself hit (those are reclaimable supply)."""
        hits = set(hit_bids)
        reclaimable = sum(1 for b in self.retained if b not in hits)
        return n_need - len(hit_bids) <= self.allocator.n_free + reclaimable

    def can_admit(self, prompt: np.ndarray, total_tokens: int) -> bool:
        _, hit_bids, n_need = self._plan(prompt, total_tokens)
        return self._fits(hit_bids, n_need)

    def _alloc(self) -> int:
        """Allocate a fresh block, reclaiming the LRU-parked prefix block
        when the free list runs dry (hits were adopted first, so the LRU
        can never evict a block the in-flight admission depends on)."""
        if not self.allocator.n_free and self.retained:
            bid, _ = self.retained.popitem(last=False)
            self.prefix.drop_block(bid)
            self.allocator.reclaim(bid)
        return self.allocator.alloc()

    def admit(self, slot: int, prompt: np.ndarray,
              total_tokens: int) -> Tuple[int, Tuple[int, ...]]:
        """Reserve blocks for one request and map them into ``slot``.

        Returns ``(n_cached_tokens, hit_bids)``: the number of leading
        prompt tokens already RESIDENT in shared blocks — the engine starts
        chunked prefill after them (recomputing at most the prompt's final
        token when the whole prompt hits, since something must produce the
        first-sample logits) — and the hit block ids the prefill depends
        on, to be polled through :meth:`blocks_ready` before the slot's
        first chunk may run (a same-step provider may not have written
        them yet).  Capacity is validated before any mutation: a raising
        ``admit`` leaves every structure untouched."""
        assert slot not in self._owned, f"slot {slot} already mapped"
        keys, plan_hits, n_need = self._plan(prompt, total_tokens)
        hit_bids = tuple(plan_hits)
        n_hit = len(hit_bids)
        if not self._fits(plan_hits, n_need):
            raise RuntimeError("admit() without free blocks; call can_admit")
        blocks = []
        for bid in hit_bids:
            if bid in self.retained:  # revive a warm parked block
                del self.retained[bid]
                self.allocator.adopt(bid)
            else:
                self.allocator.fork(bid)
            blocks.append(bid)
        blocks += [self._alloc() for _ in range(n_need - n_hit)]
        if self.prefix_reuse:
            # freshly-allocated full prompt blocks become hittable for later
            # requests the moment they are registered; they stay `pending`
            # (gating dependents via blocks_ready) until the owning prefill
            # publishes the positions that fill them
            for i in range(n_hit, len(keys)):
                old = self.prefix.get(keys[i])
                if old is not None and old != blocks[i]:
                    # chain-broken duplicate: an earlier eviction removed a
                    # key BELOW this one, so the old holder can never be hit
                    # again (hits walk the chain from key 0).  Re-registering
                    # steals the key; a parked holder is dead weight and is
                    # reclaimed outright, a live holder just loses its entry
                    self.prefix.drop_block(old)
                    if old in self.retained:
                        del self.retained[old]
                        self.allocator.reclaim(old)
                self.prefix.put(keys[i], blocks[i])
                self._pending.add(blocks[i])
        self.tables[slot] = self.sentinel
        self.tables[slot, :n_need] = blocks
        self._owned[slot] = blocks
        cached = n_hit * self.block_size
        self.prefix_hit_tokens += cached
        return cached, hit_bids

    # -- chunked-prefill support ---------------------------------------------

    def scatter_rows(self, slot: int, start: int, width: int, *,
                     lo: int, hi: int) -> np.ndarray:
        """Flat pool rows for chunk positions ``[start, start + width)``.

        Positions outside ``[lo, hi)`` — bucket padding past the prompt and
        cached-prefix positions below the write floor — are pointed at the
        out-of-range sentinel row so the dropping scatter
        skips them (shared blocks are never written, even with identical
        bytes)."""
        p = np.arange(start, start + width)
        bs = self.block_size
        rows = np.full((width,), self.sentinel * bs, np.int32)
        w = (p >= lo) & (p < hi)
        if w.any():
            blocks = np.asarray(self._owned[slot], np.int32)
            rows[w] = blocks[p[w] // bs] * bs + p[w] % bs
        return rows

    def publish(self, slot: int, upto: int) -> None:
        """Mark ``slot``'s registered prefix blocks fully covered by
        prefill positions ``[0, upto)`` as written — dependents waiting in
        :meth:`blocks_ready` may now read them."""
        bs = self.block_size
        for i, bid in enumerate(self._owned.get(slot, ())):
            if (i + 1) * bs > upto:
                break
            self._pending.discard(bid)

    def blocks_ready(self, bids) -> bool:
        """True once every hit block holds real K/V (its provider's prefill
        chunks have covered it)."""
        return all(b not in self._pending for b in bids)

    def register_chain(self, slot: int, committed: np.ndarray) -> int:
        """Register ``slot``'s blocks holding ``committed`` (the tokens its
        cache rows actually contain — prompt plus generated-so-far) under
        their chain keys, so they become prefix-hittable.  Preemption
        calls this right before ``release``: the victim's full blocks park
        on the retention LRU and its resume re-admission hits them,
        recomputing nothing already written.

        Only FULL blocks are keyed (the partial last block is recomputed
        on resume, like any prompt tail), and every keyed block is fully
        written — so nothing here joins ``_pending``.  A key already held
        by another block is left alone: that holder has identical content
        (equal chain keys imply equal prefixes), so the resume hits it
        instead.  Returns the number of newly registered blocks."""
        if not self.prefix_reuse:
            return 0
        keys = chain_keys(committed, self.block_size)
        blocks = self._owned[slot]
        added = 0
        for i, key in enumerate(keys[:len(blocks)]):
            bid = blocks[i]
            held = self.prefix.get(key)
            if held is not None:
                continue  # ours (no-op) or an equal-content block: hittable
            if self.prefix.has_block(bid):
                self.prefix.drop_block(bid)  # stale key from a prior life
            self.prefix.put(key, bid)
            added += 1
        return added

    # -- release --------------------------------------------------------------

    def release(self, slot: int) -> Tuple[int, ...]:
        """Return a finished slot's references.  A prefix block whose last
        reference drops is parked on the retention LRU (content kept warm
        for future hits) while the budget allows; everything else — and the
        LRU overflow — recycles to the free list, evicting dead prefix
        entries.

        Returns the slot's **orphaned pending blocks**: blocks this slot
        registered but never wrote (still ``_pending``) that other slots
        still reference.  For a normally-finished slot this is always
        empty (a slot binds only after publishing every registered block),
        but a prefill **cancelled** mid-flight can strand dependents that
        forked its registered-but-unwritten blocks — if nothing rewinds
        them, ``blocks_ready`` never turns true and they wait forever.
        The engine hands orphans to the waiting tasks, which adopt the
        writer role (the prefix tokens are identical, so the rewritten
        bytes are too)."""
        orphans = []
        for bid in self._owned.pop(slot):
            retain = (self.retain_blocks > 0
                      and self.allocator.refcount[bid] == 1
                      and self.prefix.has_block(bid)
                      and bid not in self._pending)
            if retain:
                self.allocator.free(bid, recycle=False)
                self.retained[bid] = None
                self.retained.move_to_end(bid)
                while len(self.retained) > self.retain_blocks:
                    old, _ = self.retained.popitem(last=False)
                    self.prefix.drop_block(old)
                    self.allocator.reclaim(old)
            elif self.allocator.free(bid) == 0:
                self.prefix.drop_block(bid)
                self._pending.discard(bid)
            elif bid in self._pending:
                orphans.append(bid)
        self.tables[slot] = self.sentinel
        return tuple(orphans)

    @property
    def fully_free(self) -> bool:
        """No live request references any block (parked warm blocks are
        reclaimable on demand, so they count as free capacity)."""
        return self.allocator.n_in_use == 0


__all__ = ["BlockAllocator", "PagedCacheManager", "PrefixCache",
           "chain_keys"]
