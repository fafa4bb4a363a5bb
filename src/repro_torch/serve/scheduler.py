"""Request-level scheduler for continuous batching.

Pure-Python bookkeeping, a copy of ``repro.serve.scheduler``.  The
:class:`Scheduler` owns the pending queues and the per-slot lifecycle

    submit -> pending -> admit(slot) -> PREFILLING -> bind -> running
           -> finish/evict -> slot free

while :class:`repro_torch.serve.engine.ContinuousEngine` owns the device side
(chunked prefill/decode, the batched KV cache, batched sampling
params).  Admission no longer implies a completed prefill: a slot spends
zero or more engine steps in the PREFILLING state while the engine feeds
its prompt in chunks (decode lanes keep advancing in between), and
``bind`` — called with the first sampled token once the final chunk's
logits land — moves it to running.  Prefilling slots are occupied (not
offered to ``next_admission``) but not decoded (absent from
``running_slots``).  Slots are recycled: the moment a request finishes,
its slot is handed to the next pending request without touching the
other in-flight rows.

**Priority classes.**  Every request carries an integer ``priority``
(0 = most urgent; default ``1``).  Pending requests queue per class and
``next_admission`` serves the head of the best (lowest-numbered)
non-empty class — within a class, admission order always equals
submission order and the ``admissible`` gate applies to the head only,
so a large request at the head of its class cannot be starved by a
stream of small ones behind it.  Across classes a **starvation bound**
holds: after ``aging_every`` consecutive admissions that bypass the
oldest class head (smallest uid among the heads), the next admission is
forced to be that oldest head — so low priority always eventually runs,
no matter how fast high-priority traffic arrives.

**Deadlines.**  ``timeout_s`` stamps an absolute ``deadline`` at submit
time; :meth:`expire_pending` (called by the engine at the top of every
step) drops still-queued requests whose deadline has passed with a
``finish_reason="cancelled"`` completion — a request that can no longer
meet its deadline never wastes a slot.  Routed/running requests keep
being expired by the HTTP front door's deadline sweep.

A request can be **cancelled** in any live state (the HTTP front door
does this on client disconnect and deadline expiry): ``find`` locates
the uid (O(1) for pending — a disconnect storm must not scan the whole
queue per cancel), ``cancel_pending``/``cancel_prefilling`` evict
un-bound requests with a ``finish_reason="cancelled"`` completion, and a
running slot goes through the ordinary ``finish`` with the explicit
``"cancelled"`` reason — the engine owns releasing the device-side slot
state and paged blocks in each case.  A running slot can also be
**preempted** (:meth:`preempt`): the slot empties WITHOUT emitting a
completion — the engine requeues the remainder of the request
(:meth:`requeue`, same uid) and merges the token halves when it finally
finishes.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_uid_counter = itertools.count()

#: every finish_reason a Completion may carry — ``finish`` rejects
#: anything else, so no reason can exist that neither the classifier nor
#: an explicit eviction path (cancel / preempt) computed
FINISH_REASONS = ("stop", "length", "cache_full", "cancelled", "preempted")


@dataclass
class Request:
    """One generation request with its own sampling parameters."""

    prompt: np.ndarray  # (prompt_len,) int32 token ids
    max_new_tokens: int
    temperature: float = 0.0  # 0 => greedy
    stop_ids: Tuple[int, ...] = ()
    priority: int = 1  # class, 0 = most urgent
    timeout_s: Optional[float] = None  # relative deadline (None = none)
    uid: int = field(default_factory=lambda: next(_uid_counter))
    submitted_at: float = 0.0  # stamped by Scheduler.submit
    deadline: float = 0.0      # absolute monotonic; 0 = none

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if int(self.priority) < 0:
            raise ValueError("priority must be >= 0 (0 = most urgent)")
        self.priority = int(self.priority)
        if self.timeout_s is not None and not self.timeout_s > 0:
            raise ValueError("timeout_s must be > 0 (or None)")


@dataclass
class Completion:
    """A finished request: generated tokens + lifecycle timestamps.

    ``first_token_at`` is 0.0 for a request cancelled before its first
    token landed (``ttft`` is NaN there — stats reducers skip such
    completions).  ``preemptions`` counts how many times the request was
    preempted and resumed before finishing (its ``tokens`` are the full
    merged stream across lives)."""

    uid: int
    prompt_len: int
    tokens: list  # generated ids, including the stop token if one fired
    finish_reason: str  # one of FINISH_REASONS
    priority: int = 1
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    preemptions: int = 0

    @property
    def latency(self) -> float:
        return self.finished_at - self.submitted_at

    @property
    def ttft(self) -> float:
        """Time to first token; NaN when no token ever landed (cancelled
        before the first sample) — a NaN poisons any reducer loudly
        instead of a huge negative epoch delta skewing it silently."""
        if self.first_token_at <= 0.0:
            return float("nan")
        return self.first_token_at - self.submitted_at


@dataclass
class _Slot:
    request: Request
    tokens: list
    first_token_at: float


class Scheduler:
    """Priority-class admission over ``n_slots`` recyclable decode slots.

    ``aging_every`` is the starvation bound: the oldest pending class
    head is bypassed by at most that many consecutive admissions before
    it is forced to the front (see the module docstring)."""

    def __init__(self, n_slots: int, *, aging_every: int = 16):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        if aging_every < 1:
            raise ValueError("need aging_every >= 1")
        self.n_slots = n_slots
        self.aging_every = aging_every
        # per-class FIFO of uids; _pending is the uid -> Request index
        # (insertion-ordered = global submission order).  Cancellation
        # deletes from the index only — queue entries whose uid is gone
        # are lazily dropped at the head, so a cancel is O(1) instead of
        # an O(n_pending) deque scan (quadratic under a disconnect storm)
        self._queues: Dict[int, deque] = {}
        self._pending: Dict[int, Request] = {}
        self._aged_bypass = 0  # admissions since the oldest head last ran
        self.slots: list = [None] * n_slots
        self.prefilling: dict = {}  # slot -> Request (admitted, not bound)
        # bounded admission log (uids, admission order) for tests/introspection
        self.admitted: deque = deque(maxlen=1024)
        # every uid this scheduler has accepted, for duplicate detection
        # (a set of ints — cheap even for very long-lived servers)
        self._seen_uids: set = set()

    # -- queue ---------------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Queue a request; returns the uid admission/completion will carry.

        The scheduler works on a private copy: stamping ``submitted_at``
        on the caller's object made a re-used :class:`Request` carry a
        stale timestamp, and resubmitting the same object reused its uid
        — colliding in every per-uid map downstream (``stream()``'s
        per-step event maps, the HTTP front door's response routing).  A
        uid this scheduler has already accepted is re-issued fresh, so
        the returned uid is always unique within this scheduler."""
        if request.uid in self._seen_uids:
            request = dataclasses.replace(request,
                                          uid=next(_uid_counter))
        else:
            request = dataclasses.replace(request)
        request.submitted_at = time.monotonic()
        if request.timeout_s is not None:
            request.deadline = request.submitted_at + request.timeout_s
        self._seen_uids.add(request.uid)
        self._enqueue(request)
        return request.uid

    def requeue(self, request: Request) -> None:
        """Re-queue a preempted request's remainder under its ORIGINAL
        uid (streams and response routes keyed by uid must survive the
        preemption), without re-stamping ``submitted_at`` — its latency
        clock keeps running across lives."""
        assert request.uid not in self._pending, "uid already pending"
        self._seen_uids.add(request.uid)
        self._enqueue(request)

    def _enqueue(self, request: Request) -> None:
        self._pending[request.uid] = request
        self._queues.setdefault(request.priority, deque()).append(
            request.uid)

    @property
    def pending(self) -> Tuple[Request, ...]:
        """Live pending requests in submission order (introspection)."""
        return tuple(self._pending.values())

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    @property
    def n_running(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def n_prefilling(self) -> int:
        return len(self.prefilling)

    @property
    def idle(self) -> bool:
        return (not self._pending and self.n_running == 0
                and not self.prefilling)

    def running_slots(self) -> list:
        """Slots in the DECODE phase (prefilling slots are excluded — they
        have no sampled token to advance yet)."""
        return [i for i, s in enumerate(self.slots) if s is not None]

    def free_slot(self) -> Optional[int]:
        """Lowest-index free slot, or None when the batch is full.
        Prefilling slots are occupied."""
        for i, s in enumerate(self.slots):
            if s is None and i not in self.prefilling:
                return i
        return None

    def _class_heads(self) -> list:
        """(priority, head Request) per non-empty class, best class
        first; lazily drops cancelled uids off each queue head."""
        heads = []
        for prio in sorted(self._queues):
            q = self._queues[prio]
            while q and q[0] not in self._pending:
                q.popleft()  # cancelled/expired: lazy deletion
            if q:
                heads.append((prio, self._pending[q[0]]))
        return heads

    def peek_next(self) -> Optional[Request]:
        """The request ``next_admission`` would offer first (the best
        class head) — the engine's preemption policy keys on it."""
        heads = self._class_heads()
        return heads[0][1] if heads else None

    def next_admission(self, admissible=None) -> Optional[Tuple[int, Request]]:
        """(slot, request) for the next admissible pending request.

        The best (lowest-numbered) non-empty priority class is served
        first, FIFO within the class.  Every ``aging_every``-th
        admission that would bypass the oldest class head (smallest uid
        among heads) is instead forced to BE that oldest head — the
        starvation bound.  ``admissible`` (e.g. the paged engine's
        free-block reservation check) gates the chosen head only: if it
        cannot be admitted, nothing is — later requests never jump the
        chosen head, so a large request cannot be starved by a stream of
        small ones."""
        slot = self.free_slot()
        if slot is None:
            return None
        heads = self._class_heads()
        if not heads:
            return None
        oldest = min(heads, key=lambda h: h[1].uid)[1]
        choice = heads[0][1]
        if self._aged_bypass >= self.aging_every - 1:
            choice = oldest
        if admissible is not None and not admissible(choice):
            return None
        if choice.uid == oldest.uid:
            self._aged_bypass = 0
        else:
            self._aged_bypass += 1
        del self._pending[choice.uid]
        return slot, choice

    # -- deadlines -----------------------------------------------------------

    def expire_pending(self, now: Optional[float] = None) -> list:
        """Drop every still-queued request whose deadline has passed;
        returns their ``finish_reason="cancelled"`` completions.  The
        engine calls this at the top of each step, so queued requests
        honour their deadline even with no HTTP front door attached."""
        now = time.monotonic() if now is None else now
        dead = [r for r in self._pending.values()
                if r.deadline and r.deadline <= now]
        out = []
        for r in dead:
            del self._pending[r.uid]
            out.append(self._cancelled(r))
        return out

    # -- cancellation --------------------------------------------------------

    def find(self, uid: int) -> Tuple[Optional[str], Optional[int]]:
        """Locate a live uid: ``("pending"|"prefilling"|"running", slot)``
        (slot is None for pending), or ``(None, None)`` when the uid is
        unknown or already finished."""
        if uid in self._pending:
            return "pending", None
        for slot, r in self.prefilling.items():
            if r.uid == uid:
                return "prefilling", slot
        for slot, s in enumerate(self.slots):
            if s is not None and s.request.uid == uid:
                return "running", slot
        return None, None

    def _cancelled(self, request: Request) -> Completion:
        return Completion(
            uid=request.uid,
            prompt_len=int(request.prompt.size),
            tokens=[],
            finish_reason="cancelled",
            priority=request.priority,
            submitted_at=request.submitted_at,
            first_token_at=0.0,  # never produced one
            finished_at=time.monotonic(),
        )

    def cancel_pending(self, uid: int) -> Optional[Completion]:
        """Drop a still-queued request; returns its 'cancelled' Completion
        (no tokens), or None if the uid is not pending.  O(1): the uid
        index is dropped here and the class queue entry lazily at its
        head — a disconnect storm stays linear overall."""
        r = self._pending.pop(uid, None)
        if r is None:
            return None
        return self._cancelled(r)

    def cancel_prefilling(self, slot: int) -> Completion:
        """Evict a mid-prefill slot (engine releases its device state and
        blocks separately); returns the 'cancelled' Completion."""
        return self._cancelled(self.prefilling.pop(slot))

    # -- per-slot lifecycle --------------------------------------------------

    def begin_prefill(self, slot: int, request: Request) -> None:
        """Occupy ``slot`` for a request whose prompt is being chunked in;
        the slot joins decode only at :meth:`bind`."""
        assert self.slots[slot] is None, f"slot {slot} busy"
        assert slot not in self.prefilling, f"slot {slot} already prefilling"
        self.prefilling[slot] = request

    def bind(self, slot: int, request: Request, first_token: int) -> None:
        """Attach an admitted request to its slot (prefill done)."""
        assert self.slots[slot] is None, f"slot {slot} busy"
        self.prefilling.pop(slot, None)
        self.admitted.append(request.uid)
        self.slots[slot] = _Slot(request=request, tokens=[int(first_token)],
                                 first_token_at=time.monotonic())

    def append_token(self, slot: int, token: int) -> None:
        self.slots[slot].tokens.append(int(token))

    def preempt(self, slot: int) -> Tuple[Request, list, float]:
        """Empty a RUNNING slot without a completion: returns the evicted
        ``(request, tokens_so_far, first_token_at)``.  The engine owns
        requeueing the remainder (:meth:`requeue`) and merging the token
        halves when the resumed request finishes — the client-visible
        stream never sees a terminal event for a preemption."""
        s = self.slots[slot]
        assert s is not None, f"preempt of empty slot {slot}"
        self.slots[slot] = None
        return s.request, s.tokens, s.first_token_at

    def finish(self, slot: int, reason: str) -> Completion:
        """Evict the slot's request and free the slot for reuse."""
        if reason not in FINISH_REASONS:
            raise ValueError(f"unknown finish_reason {reason!r}; "
                             f"expected one of {FINISH_REASONS}")
        s = self.slots[slot]
        self.slots[slot] = None
        return Completion(
            uid=s.request.uid,
            prompt_len=int(s.request.prompt.size),
            tokens=s.tokens,
            finish_reason=reason,
            priority=s.request.priority,
            submitted_at=s.request.submitted_at,
            first_token_at=s.first_token_at,
            finished_at=time.monotonic(),
        )

    def finish_reason(self, slot: int, cache_pos: int, max_len: int) -> str:
        """Classify why a slot's request stopped (host-side mirror of the
        batched done mask computed on device).  Raises on a slot that no
        natural stop condition explains — an eviction with some OTHER
        cause (cancel, preemption) must pass its reason explicitly, never
        be mislabelled ``"length"`` by a silent fallthrough."""
        s = self.slots[slot]
        if s.tokens and s.tokens[-1] in s.request.stop_ids:
            return "stop"
        if len(s.tokens) >= s.request.max_new_tokens:
            return "length"
        if cache_pos >= max_len:
            return "cache_full"
        raise ValueError(
            f"slot {slot} (uid {s.request.uid}) evicted with no stop "
            f"condition met ({len(s.tokens)}/{s.request.max_new_tokens} "
            f"tokens, cache_pos {cache_pos}/{max_len}) — pass an explicit "
            "reason for cancel/preempt evictions")


__all__ = ["Request", "Completion", "Scheduler", "FINISH_REASONS"]
