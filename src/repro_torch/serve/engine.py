"""``ContinuousEngine``: continuous-batching serving over the paged KV
layout (counterpart of ``repro.serve.engine.ContinuousEngine``; the
default paged, greedy path only).

``step()`` is the same policy loop as the JAX engine's::

    admit  — pop pending requests into free slots while their block
             reservation fits the pool; no compute happens here
    chunk  — advance in-flight prefills round-robin, one bucket-padded
             chunk at a time, spending at most ``prefill_chunk_budget``
             padded tokens per step
    bind   — a prefill that consumed its whole prompt takes its first token
             from the final chunk's logits and joins the decode batch
    decode — one batched decode step advances every bound slot at its own
             position

Prompts are consumed ``chunk_size`` tokens at a time, each span padded to
the smallest width in ``buckets`` that fits, as in JAX (torch runs
eagerly, but the widths are kept so that chunks match JAX's).  Admission
asks :class:`~repro_torch.serve.paging.PagedCacheManager` for the longest
cached block chain of the prompt and starts prefill after it.

``decode_kernel`` / ``prefill_kernel`` pick the attention as the JAX
engine's knobs do: ``"reference"`` (the gather, the default) or ``"cuda"``
(the port's counterpart of JAX's ``"pallas"``: the paged-decode and
chunk-prefill kernels, whose wrappers run the plain versions for CPU
tensors).  What the JAX engine does beyond this path is refused, with the
ROADMAP item that will port it: the dense KV layout, speculative decoding,
meshes, non-``"kv"`` cache kinds, preemption, and sampled
(temperature > 0) decoding.  Per-slot state lives on the model's device;
the pool is updated in place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.nn.attention import UnsupportedCacheError, check_kernel
from repro_torch.serve.paging import PagedCacheManager
from repro_torch.serve.sampling import SAMPLED_ROADMAP_ITEM, greedy_tokens
from repro_torch.serve.scheduler import Completion, Request, Scheduler

ROADMAP_DENSE = "the dense KV layout, generate/Engine"
ROADMAP_SPEC = "speculative decoding, preemption and cancel"
ROADMAP_FAMILIES = "port the other families"
ROADMAP_MESH = "dist and XLA tooling"


class _SlotArrays(NamedTuple):
    """Per-slot device state: the batched half of the request lifecycle."""

    tok: torch.Tensor       # (B,) int32 — last sampled token per slot
    active: torch.Tensor    # (B,) bool — slot holds a live request
    n_gen: torch.Tensor     # (B,) int32 — tokens generated so far
    max_new: torch.Tensor   # (B,) int32
    stop_ids: torch.Tensor  # (B, K) int32, -1 padded


@dataclass
class _PrefillTask:
    """Host mirror of one in-flight chunked prefill."""

    req: Request
    slot: int
    seq: int             # admission order (chunks advance round-robin in seq)
    plen: int
    cached: int          # leading tokens resident via prefix hit (no write)
    consumed: int        # prompt positions fed so far (starts at skip point)
    hit_bids: Tuple[int, ...] = ()   # shared blocks the chunks read
    logits: Optional[torch.Tensor] = None  # (1, vocab) from the last chunk


class ContinuousEngine:
    """Continuous-batching serving engine over a fixed slot batch, on the
    paged KV layout with greedy decoding.  See the module docstring."""

    def __init__(self, model, cfg, *, batch: int, max_len: int,
                 max_prompt_len: int, max_stop_ids: int = 4,
                 cache_dtype=torch.float32,
                 kv_layout: str = "paged", block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 decode_kernel: str = "reference",
                 prefill_kernel: str = "reference",
                 chunk_size: int = 32,
                 buckets: Optional[Sequence[int]] = None,
                 prefill_chunk_budget: Optional[int] = None,
                 prefix_reuse: bool = True,
                 prefix_retain_blocks: Optional[int] = None,
                 draft_model=None, spec_k: int = 0,
                 mesh=None, preemption: bool = False,
                 aging_every: int = 16):
        probe = getattr(model, "cache_kind", None)
        self.cache_kind = probe(cfg) if probe is not None else None
        if self.cache_kind != "kv":
            raise UnsupportedCacheError(
                f"{type(model).__name__} serves with cache kind "
                f"{self.cache_kind!r}; the port's engine serves the 'kv' "
                "kind only", roadmap_item=ROADMAP_FAMILIES)
        if kv_layout != "paged":
            raise UnsupportedCacheError(
                f"kv_layout={kv_layout!r}: the port serves the paged layout "
                "only", roadmap_item=ROADMAP_DENSE)
        check_kernel("decode_kernel", decode_kernel)
        check_kernel("prefill_kernel", prefill_kernel)
        if draft_model is not None or spec_k:
            raise NotImplementedError(
                f"speculative decoding is not ported [ROADMAP: "
                f"{ROADMAP_SPEC}]")
        if mesh is not None:
            raise NotImplementedError(
                f"mesh serving is not ported [ROADMAP: {ROADMAP_MESH}]")
        if preemption:
            raise NotImplementedError(
                f"priority preemption is not ported [ROADMAP: "
                f"{ROADMAP_SPEC}]")
        if not 0 < max_prompt_len < max_len:
            raise ValueError("need 0 < max_prompt_len < max_len")
        if chunk_size < 1:
            raise ValueError("need chunk_size >= 1")
        if buckets is None:
            buckets = sorted({max(1, chunk_size // 4),
                              max(1, chunk_size // 2), chunk_size})
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError("buckets must be positive widths")
        if buckets[-1] < chunk_size:
            raise ValueError(
                f"largest bucket {buckets[-1]} < chunk_size {chunk_size}: "
                "a full chunk would not fit any width")
        self.chunk_size, self.buckets = chunk_size, buckets
        self.prefill_chunk_budget = (chunk_size if prefill_chunk_budget
                                     is None else prefill_chunk_budget)
        if self.prefill_chunk_budget < 1:
            raise ValueError("need prefill_chunk_budget >= 1")
        if block_size < 1:
            raise ValueError("need block_size >= 1")
        self.decode_kernel = decode_kernel
        self.prefill_kernel = prefill_kernel
        self.model, self.cfg = model, cfg
        self.device = model.device
        self.batch, self.max_len = batch, max_len
        self.max_prompt_len, self.max_stop_ids = max_prompt_len, max_stop_ids
        self.block_size = block_size
        self.n_blocks = (batch * (-(-max_len // block_size))
                         if n_blocks is None else n_blocks)
        self.cache = model.init_paged_cache(
            batch, max_len, cfg, n_blocks=self.n_blocks,
            block_size=block_size, dtype=cache_dtype)
        retain = (self.n_blocks if prefix_retain_blocks is None
                  else prefix_retain_blocks)
        self.manager = PagedCacheManager(
            n_blocks=self.n_blocks, block_size=block_size, batch=batch,
            max_len=max_len, retain_blocks=retain if prefix_reuse else 0,
            prefix_reuse=prefix_reuse)
        self._table_dirty = False
        self._park_pos = self.manager.max_table * block_size
        dev = self.device
        self.state = _SlotArrays(
            tok=torch.zeros(batch, dtype=torch.int32, device=dev),
            active=torch.zeros(batch, dtype=torch.bool, device=dev),
            n_gen=torch.zeros(batch, dtype=torch.int32, device=dev),
            max_new=torch.ones(batch, dtype=torch.int32, device=dev),
            stop_ids=torch.full((batch, max_stop_ids), -1, dtype=torch.int32,
                                device=dev),
        )
        self.scheduler = Scheduler(batch, aging_every=aging_every)
        self._prefills: dict = {}  # slot -> _PrefillTask
        self._admit_seq = 0
        self._rr_seq = 0  # last admission seq served a chunk (rotation)
        self._step_events: list = []  # (uid, token) landed this step
        self.step_log: list = []
        self._prompt_tokens_admitted = 0
        self._prefill_tokens_computed = 0  # true prompt tokens run
        self._prefill_tokens_padded = 0    # bucket widths run (compute cost)
        self._prefix_skipped_tokens = 0    # prompt tokens never recomputed
        self._prefill_chunks = 0
        self._max_step_prefill_tokens = 0

    # -- request intake ------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, stop_ids: Sequence[int] = (),
               priority: int = 1, timeout_s: Optional[float] = None) -> int:
        """Queue one request (token ids or a prebuilt :class:`Request`);
        returns its uid."""
        if isinstance(prompt, Request):
            req = prompt
        else:
            if max_new_tokens is None:
                raise ValueError("max_new_tokens is required")
            req = Request(prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=max_new_tokens,
                          temperature=temperature, stop_ids=tuple(stop_ids),
                          priority=priority, timeout_s=timeout_s)
        if req.temperature != 0.0:
            raise NotImplementedError(
                f"temperature {req.temperature}: the port decodes greedily "
                f"only [ROADMAP: {SAMPLED_ROADMAP_ITEM}]")
        if req.prompt.size > self.max_prompt_len:
            raise ValueError(
                f"prompt length {req.prompt.size} > max_prompt_len "
                f"{self.max_prompt_len}")
        if len(req.stop_ids) > self.max_stop_ids:
            raise ValueError(f"more than {self.max_stop_ids} stop ids")
        need = self.manager.blocks_needed(self._total_tokens(req))
        if need > self.n_blocks:
            raise ValueError(
                f"request needs {need} KV blocks but the pool has only "
                f"{self.n_blocks}; raise n_blocks or lower max_new_tokens")
        return self.scheduler.submit(req)

    def _total_tokens(self, req: Request) -> int:
        """Worst-case cache positions a request can occupy (reservation)."""
        return min(int(req.prompt.size) + int(req.max_new_tokens),
                   self.max_len)

    # -- serving loop --------------------------------------------------------

    def _next_admission(self):
        return self.scheduler.next_admission(
            admissible=lambda r: self.manager.can_admit(
                r.prompt, self._total_tokens(r)))

    def _finish(self, slot: int, cache_pos: int) -> Completion:
        """Evict a finished slot: classify, release its KV blocks, and hand
        the slot back to the scheduler."""
        reason = self.scheduler.finish_reason(slot, cache_pos, self.max_len)
        self._release_slot(slot)
        return self.scheduler.finish(slot, reason)

    def _release_slot(self, slot: int) -> None:
        """Return a slot's paged blocks.  A slot releases only after its
        prefill published every block it registered, so no dependent can
        be orphaned (that needs cancellation, which is not ported)."""
        orphans = self.manager.release(slot)
        assert not orphans, f"slot {slot} released unwritten blocks {orphans}"
        self._table_dirty = True

    def _flush_table(self) -> None:
        if self._table_dirty:
            self.cache = self.cache._replace(table=torch.as_tensor(
                self.manager.tables, device=self.device))
            self._table_dirty = False

    def _bucket_width(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _begin_prefill(self, slot: int, req: Request) -> None:
        """Reserve the slot and its blocks for a request; chunks run later
        under the step budget."""
        plen = int(req.prompt.size)
        cached, hit_bids = self.manager.admit(slot, req.prompt,
                                              self._total_tokens(req))
        self._table_dirty = True
        # start AFTER the resident prefix — but always recompute at least
        # the final token: its logits seed the first sample
        start = min(cached, plen - 1)
        self._admit_seq += 1
        self._prefills[slot] = _PrefillTask(
            req=req, slot=slot, seq=self._admit_seq, plen=plen,
            cached=cached, consumed=start, hit_bids=hit_bids)
        self.scheduler.begin_prefill(slot, req)
        self._prompt_tokens_admitted += plen
        self._prefix_skipped_tokens += start
        # park the slot's write frontier out of range: the batched decode
        # still writes a K/V row for every slot, and a prefilling slot's
        # stale position could point inside a shared prefix block
        self.cache.length[:, slot] = self._park_pos

    def _chunk_extent(self, task: _PrefillTask) -> Tuple[int, int]:
        """(true length, padded bucket width) of the task's next chunk."""
        n = min(self.chunk_size, task.plen - task.consumed)
        return n, self._bucket_width(n)

    def _run_chunk(self, task: _PrefillTask, n: int, w: int) -> int:
        """Feed one bucket-padded chunk of extent ``(n, w)``; returns the
        padded width spent."""
        toks = np.zeros((1, w), np.int64)
        toks[0, :n] = task.req.prompt[task.consumed:task.consumed + n]
        final = task.consumed + n >= task.plen
        dst = self.manager.scatter_rows(task.slot, task.consumed, w,
                                        lo=task.cached, hi=task.plen)
        logits, self.cache = self.model.prefill_chunk(
            torch.as_tensor(toks, device=self.device), self.cache,
            slot=task.slot, offset=task.consumed, n_valid=n,
            dst=torch.as_tensor(dst, device=self.device), need_logits=final,
            prefill_kernel=self.prefill_kernel)
        if final:
            task.logits = logits
        task.consumed += n
        self.manager.publish(task.slot, task.consumed)
        self._prefill_tokens_computed += n
        self._prefill_tokens_padded += w
        self._prefill_chunks += 1
        return w

    def _complete_prefill(self, task: _PrefillTask) -> list:
        """Take the first token from the final chunk's logits and move the
        slot into the decode batch (possibly finishing immediately)."""
        req, slot = task.req, task.slot
        first = int(greedy_tokens(task.logits)[0])
        stop_row = np.full((self.max_stop_ids,), -1, np.int32)
        stop_row[:len(req.stop_ids)] = req.stop_ids
        done0 = (first in req.stop_ids or req.max_new_tokens <= 1
                 or task.plen >= self.max_len)
        st = self.state
        st.tok[slot] = first
        st.active[slot] = not done0
        st.n_gen[slot] = 1
        st.max_new[slot] = req.max_new_tokens
        st.stop_ids[slot] = torch.as_tensor(stop_row, device=self.device)
        del self._prefills[slot]
        self.scheduler.bind(slot, req, first)
        self._step_events.append((req.uid, first))
        if done0:
            return [self._finish(slot, task.plen)]
        return []

    def _advance_prefills(self) -> Tuple[list, int]:
        """Run chunks round-robin under the step budget, rotating the
        starting task across steps (see the JAX engine's method of the
        same name).  A task whose prefix-hit blocks are still being written
        by an earlier prefill waits until they publish."""
        finished: list = []
        spent = 0
        progressed = True
        while self._prefills and progressed:
            progressed = False
            tasks = sorted(self._prefills.values(), key=lambda t: t.seq)
            pivot = next((i for i, t in enumerate(tasks)
                          if t.seq > self._rr_seq), 0)
            for task in tasks[pivot:] + tasks[:pivot]:
                if not self.manager.blocks_ready(task.hit_bids):
                    continue
                n, w = self._chunk_extent(task)
                if spent and spent + w > self.prefill_chunk_budget:
                    return finished, spent
                spent += self._run_chunk(task, n, w)
                self._rr_seq = task.seq
                progressed = True
                if task.consumed >= task.plen:
                    finished.extend(self._complete_prefill(task))
        return finished, spent

    def _decode(self):
        """One batched greedy decode step over every slot; inactive slots
        keep their token and position (their writes drop)."""
        st, old_len = self.state, self.cache.length
        logits, cache = self.model.decode(st.tok[:, None].long(), self.cache,
                                          decode_kernel=self.decode_kernel)
        nxt = torch.where(st.active, greedy_tokens(logits[:, 0]), st.tok)
        length = torch.where(st.active[None, :], cache.length, old_len)
        self.cache = cache._replace(length=length)
        n_gen = torch.where(st.active, st.n_gen + 1, st.n_gen)
        stop_hit = (nxt[:, None] == st.stop_ids).any(dim=-1)
        done = st.active & (stop_hit | (n_gen >= st.max_new)
                            | (length[0] >= self.max_len))
        self.state = st._replace(tok=nxt, active=st.active & ~done,
                                 n_gen=n_gen)
        return nxt, done

    @torch.no_grad()
    def step(self) -> list:
        """One scheduling round: admit, chunk prefills under the budget,
        bind finished prefills, then one batched decode step.  Returns the
        :class:`Completion`s finished this step."""
        t0 = time.monotonic()
        self._step_events = []
        finished = self.scheduler.expire_pending()
        while (adm := self._next_admission()) is not None:
            self._begin_prefill(*adm)
        prefill_spent = 0
        if self._prefills:
            self._flush_table()
            done, prefill_spent = self._advance_prefills()
            finished.extend(done)
            self._max_step_prefill_tokens = max(
                self._max_step_prefill_tokens, prefill_spent)
        running = self.scheduler.running_slots()
        if running:
            self._flush_table()
            nxt, done = self._decode()
            nxt_np, done_np = nxt.cpu().numpy(), done.cpu().numpy()
            pos_np = self.cache.length[0].cpu().numpy()
            for slot in running:
                self.scheduler.append_token(slot, nxt_np[slot])
                self._step_events.append(
                    (self.scheduler.slots[slot].request.uid,
                     int(nxt_np[slot])))
                if done_np[slot]:
                    finished.append(self._finish(slot, int(pos_np[slot])))
        self.step_log.append({
            "wall_s": time.monotonic() - t0,
            "prefill_tokens": prefill_spent,
            "decoded": bool(running),
        })
        return finished

    # -- introspection -------------------------------------------------------

    @property
    def step_events(self) -> Tuple[Tuple[int, int], ...]:
        """``(uid, token)`` pairs emitted by the most recent ``step()``."""
        return tuple(self._step_events)

    def kv_stats(self) -> dict:
        """Device-memory accounting for the paged KV pool (bytes):
        ``kv_allocated_bytes`` is what the pool reserves up front,
        ``kv_peak_resident_bytes`` the high-water mark of blocks holding
        live tokens.  Parked (LRU-retained) prefix blocks are excluded."""
        k = self.cache.k
        alloc = 2 * k.numel() * k.element_size()
        block_bytes = 2 * (k.numel() // self.n_blocks) * k.element_size()
        a = self.manager.allocator
        return {
            "kv_layout": "paged", "cache_kind": self.cache_kind,
            "kv_allocated_bytes": alloc,
            "kv_peak_resident_bytes": a.peak_in_use * block_bytes,
            "kv_block_bytes": block_bytes,
            "block_size": self.block_size, "n_blocks": self.n_blocks,
            "peak_blocks_in_use": a.peak_in_use,
            "blocks_in_use": a.n_in_use,
            "blocks_retained": len(self.manager.retained),
            "prefix_hit_tokens": self.manager.prefix_hit_tokens,
            "decode_kernel": self.decode_kernel,
            "prefill_kernel": self.prefill_kernel}

    def prefill_stats(self) -> dict:
        """Admission-path accounting: how much prompt compute ran (vs was
        skipped via prefix hits) and how bursty it was per step."""
        admitted = self._prompt_tokens_admitted
        return {
            "chunk_size": self.chunk_size,
            "buckets": list(self.buckets),
            "prefill_chunk_budget": self.prefill_chunk_budget,
            "prompt_tokens_admitted": admitted,
            "prefill_tokens_computed": self._prefill_tokens_computed,
            "prefill_tokens_padded": self._prefill_tokens_padded,
            "prefix_skipped_tokens": self._prefix_skipped_tokens,
            "prefix_hit_rate": (self._prefix_skipped_tokens / admitted
                                if admitted else 0.0),
            "prefill_chunks": self._prefill_chunks,
            "max_step_prefill_tokens": self._max_step_prefill_tokens,
            "prefill_kernel": self.prefill_kernel,
        }

    def reset_stats(self) -> None:
        """Zero the prefill/step accounting (e.g. after a warmup) without
        touching the serving state; the KV peak rebases to the blocks in
        use."""
        self.step_log = []
        self._prompt_tokens_admitted = 0
        self._prefill_tokens_computed = 0
        self._prefill_tokens_padded = 0
        self._prefix_skipped_tokens = 0
        self._prefill_chunks = 0
        self._max_step_prefill_tokens = 0
        self.manager.prefix_hit_tokens = 0
        a = self.manager.allocator
        a.peak_in_use = a.n_in_use

    # -- drivers -------------------------------------------------------------

    def run(self, max_steps: Optional[int] = None) -> list:
        """Step until every submitted request has finished."""
        out, steps = [], 0
        while not self.scheduler.idle:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return sorted(out, key=lambda c: c.uid)


__all__ = ["ContinuousEngine", "Request", "Completion",
           "UnsupportedCacheError"]
