"""Arrival-trace generation and replay for serving benchmarks (counterpart
of ``repro.serve.trace``; the same numpy sampling, so one seed gives one
trace in both packages).

A trace is a list of ``(arrival_tick, Request)`` pairs: inter-arrival gaps
are exponential (a Poisson process in units of decode steps, scaled by
``load`` = expected new requests per decode step), prompt lengths and
generation budgets are sampled per request.  ``replay`` drives a
:class:`~repro_torch.serve.engine.ContinuousEngine` through the trace — requests
are submitted when the engine's step counter passes their arrival tick, so
admission genuinely interleaves with in-flight decoding — and
``latency_stats`` reduces the completions to throughput + p50/p95.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.scheduler import Completion, Request


def make_trace(n_requests: int, *, seed: int = 0, load: float = 0.25,
               min_prompt: int = 4, max_prompt: int = 64,
               min_new: int = 4, max_new: int = 32,
               temperature: float = 0.0, vocab: int = 256,
               shared_prefix: int = 0, long_frac: float = 0.0,
               long_prompt: int = 0,
               priority_mix: Optional[Sequence[float]] = None,
               timeout_s: Optional[float] = None,
               ) -> List[Tuple[float, Request]]:
    """Sample a reproducible trace of variable-length requests.

    ``shared_prefix > 0`` prepends one common random prefix of that many
    tokens to every prompt — the shared-system-prompt workload the paged
    engine's prefix cache serves from a single refcounted block set.

    ``long_frac``/``long_prompt`` mix in a heavy tail: each request is,
    with probability ``long_frac``, a ``long_prompt``-token prompt instead
    of a ``[min_prompt, max_prompt]`` draw — the mixed long/short workload
    where monolithic prefill stalls decode and chunked prefill must not.

    ``priority_mix`` turns on mixed-priority traffic: weights over the
    priority classes ``0..len(mix)-1`` (e.g. ``(0.2, 0.8)`` = 20% class-0
    urgent, 80% class-1), sampled per request.  ``timeout_s`` stamps the
    same queued-admission deadline onto every request."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(load, 1e-6), n_requests)
    arrivals = np.cumsum(gaps)
    prefix = (rng.integers(0, vocab, shared_prefix).astype(np.int32)
              if shared_prefix else None)
    classes = weights = None
    if priority_mix is not None:
        weights = np.asarray(priority_mix, np.float64)
        if weights.ndim != 1 or weights.size < 1 or (weights < 0).any() \
                or weights.sum() <= 0:
            raise ValueError("priority_mix must be non-negative weights")
        weights = weights / weights.sum()
        classes = np.arange(weights.size)
    trace = []
    for t in arrivals:
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        if long_frac and rng.random() < long_frac:
            plen = long_prompt
        prompt = rng.integers(0, vocab, plen).astype(np.int32)
        if prefix is not None:
            prompt = np.concatenate([prefix, prompt])
        trace.append((float(t), Request(
            prompt=prompt,
            max_new_tokens=int(rng.integers(min_new, max_new + 1)),
            temperature=temperature,
            priority=(int(rng.choice(classes, p=weights))
                      if classes is not None else 1),
            timeout_s=timeout_s,
        )))
    return trace


def replay(engine, trace: List[Tuple[float, Request]],
           max_steps: int = 100_000) -> Tuple[List[Completion], float]:
    """Run a trace to completion. Returns (completions, wall seconds)."""
    pending = sorted(trace, key=lambda p: p[0])
    done: List[Completion] = []
    i, tick = 0, 0
    t0 = time.monotonic()
    while i < len(pending) or not engine.scheduler.idle:
        while i < len(pending) and pending[i][0] <= tick:
            engine.submit(pending[i][1])  # engine-level limit validation
            i += 1
        done.extend(engine.step())
        tick += 1
        if tick >= max_steps:
            raise RuntimeError(f"trace did not drain in {max_steps} steps")
    return sorted(done, key=lambda c: c.uid), time.monotonic() - t0


def latency_stats(completions: List[Completion], wall: float) -> dict:
    """Throughput + per-request latency percentiles for a replay."""
    if not completions:
        return {"requests": 0, "generated_tokens": 0, "wall_s": wall,
                "tokens_per_s": 0.0, "latency_p50_ms": 0.0,
                "latency_p95_ms": 0.0, "ttft_p50_ms": 0.0,
                "ttft_p95_ms": 0.0}
    lats = np.array([c.latency for c in completions])
    # a request cancelled before its first token has first_token_at == 0.0
    # — its "ttft" would be a huge negative epoch delta, not a latency
    ttfts = np.array([c.ttft for c in completions if c.first_token_at > 0]
                     or [0.0])
    n_tok = int(sum(len(c.tokens) for c in completions))
    return {
        "requests": len(completions),
        "generated_tokens": n_tok,
        "wall_s": wall,
        "tokens_per_s": n_tok / max(wall, 1e-9),
        "latency_p50_ms": float(np.percentile(lats, 50) * 1e3),
        "latency_p95_ms": float(np.percentile(lats, 95) * 1e3),
        "ttft_p50_ms": float(np.percentile(ttfts, 50) * 1e3),
        "ttft_p95_ms": float(np.percentile(ttfts, 95) * 1e3),
    }


def stall_stats(step_log: List[dict]) -> dict:
    """Admission-latency profile of one replay from the engine's per-step
    log: how long each engine step took (each step ends in at most one
    batched decode advance, so a step's wall time IS the inter-decode-step
    stall its prefill work causes) and how many padded prefill tokens were
    computed inside single steps — the deterministic counterpart the
    benchmark asserts on (wall times are recorded, not asserted)."""
    if not step_log:
        return {"steps": 0, "step_wall_p50_ms": 0.0, "step_wall_p95_ms": 0.0,
                "step_wall_max_ms": 0.0, "step_prefill_tokens_p95": 0.0,
                "step_prefill_tokens_max": 0}
    walls = np.array([s["wall_s"] for s in step_log])
    ptoks = np.array([s["prefill_tokens"] for s in step_log])
    return {
        "steps": len(step_log),
        "step_wall_p50_ms": float(np.percentile(walls, 50) * 1e3),
        "step_wall_p95_ms": float(np.percentile(walls, 95) * 1e3),
        "step_wall_max_ms": float(walls.max() * 1e3),
        "step_prefill_tokens_p95": float(np.percentile(ptoks, 95)),
        "step_prefill_tokens_max": int(ptoks.max()),
    }


def bench_trace(model, cfg, trace: List[Tuple[float, Request]], *,
                batch: int, max_len: int, max_prompt_len: int,
                **engine_kwargs) -> Tuple[List[Completion], dict]:
    """Build a ContinuousEngine, warm it up once per chunk bucket width,
    then replay ``trace`` — the shared body of the serve driver.
    Extra kwargs (``kv_layout``, ``block_size``, ``chunk_size``, ...) pass
    through to the engine; its ``kv_stats()``, ``prefill_stats()``, and
    the per-step stall profile are merged into the stats."""
    from repro_torch.serve.engine import ContinuousEngine

    engine = ContinuousEngine(model, cfg, batch=batch, max_len=max_len,
                              max_prompt_len=max_prompt_len, **engine_kwargs)
    # warmup: one prompt per reachable chunk bucket width, so the replay
    # pays no first-call cost (kernel build, allocator growth)
    for plen in sorted({min(w, max_prompt_len) for w in engine.buckets}):
        engine.submit(np.zeros(plen, np.int32), max_new_tokens=2)
    engine.run()
    engine.reset_stats()  # profile the trace, not the warmup
    completions, wall = replay(engine, trace)
    stats = latency_stats(completions, wall)
    stats.update(engine.kv_stats())
    stats.update(engine.prefill_stats())
    stats.update(stall_stats(engine.step_log))
    return completions, stats


def greedy_agreement(a: List[Completion], b: List[Completion]) -> float:
    """Mean per-request token agreement between two replays of one trace
    (compared over the common prefix when lengths differ).

    Pairs with no overlapping tokens — e.g. one side cancelled before its
    first token — carry no evidence either way and are skipped rather
    than poisoning the mean with NaN; with no comparable pair at all the
    agreement is vacuously 1.0."""
    scores = []
    for ca, cb in zip(a, b):
        n = min(len(ca.tokens), len(cb.tokens))
        if n == 0:
            continue
        ta, tb = np.array(ca.tokens[:n]), np.array(cb.tokens[:n])
        scores.append(np.mean(ta == tb))
    return float(np.mean(scores)) if scores else 1.0


def format_stats(label: str, stats: dict) -> str:
    return (f"{label:11s}: {stats['tokens_per_s']:9.1f} tok/s   "
            f"p50 {stats['latency_p50_ms']:7.1f} ms   "
            f"p95 {stats['latency_p95_ms']:7.1f} ms   "
            f"ttft p50 {stats['ttft_p50_ms']:6.1f} ms   "
            f"({stats['requests']} reqs, {stats['generated_tokens']} tok)")


def format_kv_stats(label: str, stats: dict) -> str:
    """One-line render of ``ContinuousEngine.kv_stats()`` (merged into
    ``bench_trace`` stats) — the single formatter for every driver."""
    extra = ""
    layout = stats["kv_layout"]
    kind = stats.get("cache_kind", "kv")
    if layout == "paged":
        extra = (f"   ({stats['peak_blocks_in_use']}/{stats['n_blocks']} "
                 f"blocks x {stats['block_size']} tok, "
                 f"{stats['prefix_hit_tokens']} prefix-hit tok)")
    if "draft_kv_allocated_bytes" in stats:  # speculative draft pool
        extra += (f"   (+draft "
                  f"{stats['draft_kv_allocated_bytes'] / 1024:.1f} KiB)")
    elif kind != "kv":  # per-slot ring / ssm / hybrid state
        layout = kind
        if "kv_lane_tokens" in stats:
            extra = f"   (ring lanes x {stats['kv_lane_tokens']} tok)"
    return (f"{label:11s}: KV[{layout}] resident "
            f"{stats['kv_peak_resident_bytes'] / 1024:8.1f} KiB / allocated "
            f"{stats['kv_allocated_bytes'] / 1024:8.1f} KiB{extra}")


def format_prefill_stats(label: str, stats: dict) -> str:
    """One-line render of the admission-path profile (merged
    ``prefill_stats()`` + ``stall_stats``)."""
    return (f"{label:11s}: prefill {stats['prefill_tokens_computed']}"
            f"/{stats['prompt_tokens_admitted']} tok computed "
            f"({stats['prefix_hit_rate']:.0%} prefix-skip)   "
            f"chunks {stats['prefill_chunks']} "
            f"@<= {stats['max_step_prefill_tokens']} tok/step   "
            f"step p95 {stats['step_wall_p95_ms']:6.2f} ms "
            f"max {stats['step_wall_max_ms']:6.2f} ms")


__all__ = ["make_trace", "replay", "latency_stats", "stall_stats",
           "format_stats", "format_kv_stats", "format_prefill_stats",
           "bench_trace", "greedy_agreement"]
