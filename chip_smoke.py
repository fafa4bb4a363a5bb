#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing its numbers; any failure raises and the script exits
non-zero:

1. device and build — the card's name and power limit, torch and CUDA
   versions, and the three kernels built from ``src/repro_torch/csrc``
   (one ``nvcc`` each, all started together);
2. kernel parity — the LED kernel against its plain PyTorch version at
   every shape the serving path gives it and at ragged shapes, in bf16 and
   fp32, then CUDA-event times of the kernel, the plain version and
   ``torch.matmul(torch.matmul(x, a), b)`` (a yardstick the port never
   calls) beside the card's least time for the same work;
3. serve — qwen2.5-3b at full width and depth in bf16 from a seeded
   generator, ``auto_fact``-ed (rank 0.5, embed and lm_head excluded, gate
   off), served greedily through ``ContinuousEngine`` on a seeded trace
   with a shared prefix and the reference gather attention; checks every
   completion, the prefix hits and the LED kernel's launch count on that
   run, and holds one decode step's logits through the kernel against the
   plain version on the same cache state;
4. attention kernels — the paged-decode and chunk-prefill kernels against
   their plain versions at the serving shapes and at ragged and edge cases
   (head ratios, block sizes, sentinel holes, empty slots, the frozen
   cache-full slot, prefix resumes mid-block, padded chunks), q in bf16 and
   fp32 times the pool in fp32 and bf16; then CUDA-event times of each
   kernel (its wrapper's calls, and the same calls replayed from a CUDA
   graph, which leaves the host's work out), its plain version and
   ``scaled_dot_product_attention`` on the
   pre-gathered lane (a yardstick the port never calls; the gather is not
   timed) beside the card's least time for the same work;
5. serve with every kernel — the same model and trace again with
   ``decode_kernel="cuda", prefill_kernel="cuda"``: every count set to 0
   just before the replay and read just after, held to its exact value;
   one decode step's and one final chunk's logits through the attention
   kernels against the reference attention on the same cache state; the
   greedy-token agreement with the phase-3 run (printed: bf16 near-ties
   may flip), and, from one more reference replay that keeps each sampled
   token's top-2 logit gap, the gap where each request's streams part;
6. fp32 exactness — qwen2.5-3b at full width cut to 2 layers, in fp32,
   ``auto_fact``-ed, serves the trace with the reference attention and with
   the kernels: the greedy tokens must be equal;
7. the kernel summary line, the card line, and the result line.

Needs one CUDA card and ``nvcc``; without a card it exits non-zero before
printing any result.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (NVIDIA H100 SXM data sheet; dense rates)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # fp32 without TF32

ARCH = "qwen2.5-3b"
RANK = 0.5
BATCH, MAX_LEN, MAX_PROMPT, SHARED_PREFIX = 8, 256, 128, 32
BLOCK_SIZE, CHUNK = 16, 32
N_REQUESTS, MIN_NEW, MAX_NEW = 8, 16, 32
# one decode step through the kernel vs the plain version, bf16: each of the
# 252 products may round its output one bf16 ulp (2^-8 relative) apart, and
# 36 residual layers carry that to a few percent of the logits' scale
LOGIT_RTOL = 5e-2
TIMING_REPS = 20
KERNELS = ("led_matmul", "paged_attention", "chunk_attention")
# attention parity: fp32 differs in summation order only; a bf16 output is
# one rounding of nearly the same fp32 value, at most two bf16 ulps of
# max|out| apart
ATTN_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
FP32_LAYERS = 2  # depth of the fp32 exactness run (full width)


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = TIMING_REPS, replays: int = 5) -> float:
    """Mean device milliseconds of one ``fn`` call: ``reps`` calls captured
    in one CUDA graph and replayed, so that the host's work per call (the
    wrapper's checks, ctypes, the launch) lies outside the timed region.
    What remains is the kernels' time and the graph's gaps between them."""
    import torch

    fn()  # builds, loads and sets kernel attributes before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def led_bound_ms(m: int, k: int, r: int, n: int, dtype: str) -> tuple:
    """(least ms, what bounds it) for one ``(x @ A) @ B``: each input read
    once and the output written once, over the card's memory rate, against
    the product's operations over the peak rate of the dtype."""
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (m * k + k * r + r * n + m * n) * size
    flops = 2 * m * r * (k + n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device_and_build() -> None:
    import torch

    from repro_torch.kernels import _build

    log("== phase 1: device and build")
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  python "
        f"{sys.version.split()[0]}  devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = _build.build_all(KERNELS)  # one nvcc per source, started together
    for name, path in paths.items():
        log(f"built {path.relative_to(ROOT)} (in place after "
            f"{_build.build_seconds[name]:.2f} s)")
    log(f"all kernels built in {time.perf_counter() - t0:.2f} s")


def projection_shapes(cfg) -> dict:
    """(K, R, N) of each factorized projection at rank ``RANK``, gate off
    (R = RANK * min(K, N), as ``auto_fact(gate=False)`` resolves it)."""
    d, kv = cfg.d_model, cfg.n_kv_heads * cfg.resolved_head_dim
    q = cfg.n_heads * cfg.resolved_head_dim

    def shape(k, n):
        return k, max(1, int(RANK * min(k, n))), n

    return {"q": shape(d, q), "k": shape(d, kv), "v": shape(d, kv),
            "o": shape(q, d), "gate": shape(d, cfg.d_ff),
            "up": shape(d, cfg.d_ff), "down": shape(cfg.d_ff, d)}


def phase_kernel_parity(cfg, buckets) -> dict:
    import torch

    from repro_torch.kernels.led_matmul import led_matmul, led_matmul_torch

    log("== phase 2: kernel parity (LED kernel vs plain version)")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    shapes = projection_shapes(cfg)
    rows = sorted({1, BATCH, *buckets})

    def inputs(m, k, r, n, dtype):
        x = torch.randn(m, k, generator=gen, device="cuda")
        a = torch.randn(k, r, generator=gen, device="cuda") / k ** 0.5
        b = torch.randn(r, n, generator=gen, device="cuda") / r ** 0.5
        return x.to(dtype), a.to(dtype), b.to(dtype)

    def check(m, k, r, n, dtype) -> float:
        x, a, b = inputs(m, k, r, n, dtype)
        y = led_matmul(x, a, b)
        torch.cuda.synchronize()
        ref = led_matmul_torch(x, a, b)
        scale = ref.float().abs().max().item()
        err = (y.float() - ref.float()).abs().max().item()
        # fp32: summation order only; bf16: one rounding of the same fp32
        # value, so at most a couple of bf16 ulps of max|y|
        tol = (1e-4 if dtype == torch.float32 else 2 * 2 ** -7) * scale
        ok = y.shape == ref.shape and y.dtype == ref.dtype and err <= tol
        log(f"  parity {str(dtype)[6:]:8s} M={m:<3d} K={k:<5d} R={r:<5d} "
            f"N={n:<5d} max_abs_err {err:.3e} tol {tol:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"LED kernel disagrees at {(m, k, r, n)} "
                                 f"{dtype}: {err} > {tol}")
        return err

    ragged = [(33, 100, 17, 130), (5, 77, 1, 3), (19, 300, 257, 513),
              (7, 2049, 3, 255), (65, 511, 129, 1000)]
    for dtype in (torch.bfloat16, torch.float32):
        for k, r, n in sorted(set(shapes.values())):
            for m in rows:
                check(m, k, r, n, dtype)
        for shape in ragged:
            check(*shape, dtype)

    log("  times, bf16 (ms; least = card's bound; lib = torch.matmul chain)")
    per_shape = []
    for name in ("q", "k", "gate", "down"):
        k, r, n = shapes[name]
        for m in (1, BATCH, max(buckets)):
            x, a, b = inputs(m, k, r, n, torch.bfloat16)
            ms = cuda_ms(lambda: led_matmul(x, a, b))
            plain = cuda_ms(lambda: led_matmul_torch(x, a, b))
            lib = cuda_ms(lambda: torch.matmul(torch.matmul(x, a), b))
            bound, by = led_bound_ms(m, k, r, n, "bfloat16")
            per_shape.append(dict(proj=name, m=m, k=k, r=r, n=n, ms=ms,
                                  plain_ms=plain, library_ms=lib,
                                  bound_ms=bound, bound_by=by))
            log(f"  time {name:5s} M={m:<3d} K={k:<5d} R={r:<5d} N={n:<5d} "
                f"kernel {ms:.4f}  plain {plain:.4f}  lib {lib:.4f}  "
                f"least {bound:.4f} ({by})")

    # one layer's seven LED products at decode (M = batch): the unit the
    # serving path repeats per layer per step
    unit = [inputs(BATCH, *shapes[p], torch.bfloat16) for p in shapes]
    errs = []
    for x, a, b in unit:
        y = led_matmul(x, a, b)
        torch.cuda.synchronize()
        errs.append((y.float() - led_matmul_torch(x, a, b).float())
                    .abs().max().item())
    unit_ms = cuda_ms(lambda: [led_matmul(*t) for t in unit])
    unit_dev = graph_ms(lambda: [led_matmul(*t) for t in unit])
    unit_plain = cuda_ms(lambda: [led_matmul_torch(*t) for t in unit])
    unit_lib = cuda_ms(lambda: [torch.matmul(torch.matmul(x, a), b)
                                for x, a, b in unit])
    unit_bound = sum(led_bound_ms(BATCH, *shapes[p], "bfloat16")[0]
                     for p in shapes)
    log(f"  decode layer (7 products, M={BATCH}, bf16): kernel "
        f"{unit_ms:.4f} ms (in a CUDA graph {unit_dev:.4f} ms)  plain "
        f"{unit_plain:.4f} ms  lib {unit_lib:.4f} ms  least "
        f"{unit_bound:.4f} ms (bytes)")
    return {"per_shape": per_shape, "unit": dict(
        ms=unit_ms, device_ms=unit_dev, plain_ms=unit_plain,
        library_ms=unit_lib,
        bound_ms=unit_bound, max_abs_err=max(errs))}


def phase_serve(cfg) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import auto_fact
    from repro_torch.kernels.led_matmul import led_matmul
    from repro_torch.models import TransformerLM
    from repro_torch.nn.linear import LED
    from repro_torch.serve import ContinuousEngine
    from repro_torch.serve.scheduler import FINISH_REASONS
    from repro_torch.serve.trace import latency_stats, make_trace, replay

    log(f"== phase 3: serve {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype})")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = TransformerLM.create(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  built from seed 0 in {time.perf_counter() - t0:.1f} s, "
        f"{n_params:,} params")
    t0 = time.perf_counter()
    model, report = auto_fact(model, RANK, solver="svd",
                              exclude=["embed", "lm_head"], gate=False,
                              return_report=True)
    torch.cuda.synchronize()
    log(f"  auto_fact solver=svd rank={RANK} gate=False in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in report.summary().splitlines():
        log("  " + line)
    n_led = sum(isinstance(m, LED) for m in model.modules())
    assert n_led == 7 * cfg.n_layers, n_led
    assert all(m.fuse == "auto" for m in model.modules()
               if isinstance(m, LED))

    engine = ContinuousEngine(model, cfg, batch=BATCH, max_len=MAX_LEN,
                              max_prompt_len=MAX_PROMPT,
                              block_size=BLOCK_SIZE, chunk_size=CHUNK)
    t0 = time.perf_counter()
    for plen in engine.buckets:  # first call at each chunk width
        engine.submit(np.zeros(plen, np.int32), max_new_tokens=2)
    engine.run()
    engine.reset_stats()
    log(f"  warm-up ({len(engine.buckets)} prompts) "
        f"{time.perf_counter() - t0:.1f} s")

    trace = make_trace(N_REQUESTS, seed=0, load=0.5, min_prompt=4,
                       max_prompt=MAX_PROMPT - SHARED_PREFIX,
                       min_new=MIN_NEW, max_new=MAX_NEW, vocab=cfg.vocab,
                       shared_prefix=SHARED_PREFIX)
    led_matmul.launches = 0
    done, wall = replay(engine, trace)
    torch.cuda.synchronize()
    launches = led_matmul.launches

    stats = latency_stats(done, wall)
    pstats, kstats = engine.prefill_stats(), engine.kv_stats()
    decode_steps = sum(s["decoded"] for s in engine.step_log)
    pure_decode = [s["wall_s"] for s in engine.step_log
                   if s["decoded"] and not s["prefill_tokens"]]
    assert len(done) == N_REQUESTS
    for (_, req), comp in zip(trace, done):
        assert comp.finish_reason in FINISH_REASONS, comp.finish_reason
        assert comp.finish_reason == "length", comp.finish_reason
        assert len(comp.tokens) == req.max_new_tokens, comp
        assert all(0 <= t < cfg.vocab for t in comp.tokens)
    assert kstats["prefix_hit_tokens"] > 0, kstats
    assert engine.manager.allocator.n_in_use == 0
    per_pass = 7 * cfg.n_layers
    expected = per_pass * (decode_steps + pstats["prefill_chunks"])
    assert launches >= per_pass * decode_steps, (launches, decode_steps)
    assert launches == expected, (launches, expected)
    log(f"  served {stats['requests']} requests, "
        f"{stats['generated_tokens']} tokens in {wall:.2f} s: "
        f"{stats['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{stats['ttft_p50_ms']:.1f} ms p95 {stats['ttft_p95_ms']:.1f} ms, "
        f"latency p50 {stats['latency_p50_ms']:.1f} ms")
    log(f"  decode steps {decode_steps}, mean decode-only step "
        f"{1e3 * float(np.mean(pure_decode)):.1f} ms over "
        f"{len(pure_decode)} steps; prefill chunks "
        f"{pstats['prefill_chunks']}, {pstats['prefill_tokens_computed']}/"
        f"{pstats['prompt_tokens_admitted']} prompt tokens computed, "
        f"prefix hit tokens {kstats['prefix_hit_tokens']}")
    log(f"  LED launches on the served run {launches} = {per_pass} x "
        f"({decode_steps} decode steps + {pstats['prefill_chunks']} chunks)")
    log(f"  peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    logits_err = decode_logits_kernel_vs_plain(model, cfg, trace)
    return {"launches": launches, "decode_steps": decode_steps,
            "stats": stats, "logits_err": logits_err, "model": model,
            "trace": trace, "done": done}


def decode_logits_kernel_vs_plain(model, cfg, trace) -> float:
    """One decode step on the same cache state, through the kernel
    (``fuse="auto"``) and through the plain version (``fuse="torch"``)."""
    import numpy as np
    import torch

    from repro_torch.nn.linear import LED

    prompts = [req.prompt[-CHUNK:] for _, req in trace[:BATCH]]
    n_blocks = BATCH * (MAX_LEN // BLOCK_SIZE)
    cache = model.init_paged_cache(BATCH, MAX_LEN, cfg, n_blocks=n_blocks,
                                   block_size=BLOCK_SIZE, dtype=torch.float32)
    max_table = MAX_LEN // BLOCK_SIZE
    table = np.arange(n_blocks, dtype=np.int32).reshape(BATCH, max_table)
    cache = cache._replace(table=torch.as_tensor(table, device="cuda"))
    for slot, prompt in enumerate(prompts):
        n = len(prompt)
        toks = torch.zeros((1, CHUNK), dtype=torch.long, device="cuda")
        toks[0, :n] = torch.as_tensor(prompt, device="cuda")
        p = np.arange(CHUNK)
        dst = np.where(p < n, table[slot, p // BLOCK_SIZE] * BLOCK_SIZE
                       + p % BLOCK_SIZE, n_blocks * BLOCK_SIZE)
        _, cache = model.prefill_chunk(
            toks, cache, slot=slot, offset=0, n_valid=n,
            dst=torch.as_tensor(dst, device="cuda"))
    tok = torch.as_tensor([[int(p[-1])] for p in prompts], device="cuda")
    saved = (cache.k.clone(), cache.v.clone(), cache.length.clone())
    kernel_logits, _ = model.decode(tok, cache)
    leds = [m for m in model.modules() if isinstance(m, LED)]
    for m in leds:
        m.fuse = "torch"
    try:
        cache.k.copy_(saved[0])
        cache.v.copy_(saved[1])
        cache = cache._replace(length=saved[2])
        plain_logits, _ = model.decode(tok, cache)
    finally:
        for m in leds:
            m.fuse = "auto"
    torch.cuda.synchronize()
    kl, pl = kernel_logits.float(), plain_logits.float()
    assert torch.isfinite(kl).all() and kl.shape == (BATCH, 1, cfg.vocab)
    err = (kl - pl).abs().max().item()
    scale = pl.abs().max().item()
    agree = (kl.argmax(-1) == pl.argmax(-1)).float().mean().item()
    log(f"  decode logits, kernel vs plain on one cache state: max_abs_err "
        f"{err:.4e}, max|logits| {scale:.3f}, tol {LOGIT_RTOL * scale:.4e}, "
        f"argmax agreement {agree:.3f}")
    assert err <= LOGIT_RTOL * scale, (err, scale)
    return err


# ---- phase 4: the attention kernels -----------------------------------------


def _paged_layout(rng, batch: int, n_table: int, bs: int, pos) -> tuple:
    """(table (batch, n_table), n_blocks): slot b owns the distinct blocks
    its positions ``0..pos[b]`` need (the manager's reservation, capped at
    the table), the rest of its row is the sentinel ``n_blocks``."""
    import numpy as np

    n_blocks = batch * n_table + 2
    table = np.full((batch, n_table), n_blocks, np.int32)
    perm = rng.permutation(n_blocks)
    used = 0
    for b, p in enumerate(pos):
        need = min(p // bs + 1, n_table)
        table[b, :need] = perm[used:used + need]
        used += need
    return table, n_blocks


def _randn(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def decode_case(gen, rng, *, batch, heads, kvh, hd, bs, n_table, q_dtype,
                pool_dtype, edges: bool) -> tuple:
    """Inputs of one ``paged_attention`` call.  With ``edges`` the first
    slots sit at the block edge (pos = bs - 1 and bs), frozen at
    pos = n_table * bs (cache full), hold an all-sentinel table, and hold a
    sentinel hole inside their window; the others take random positions.
    Returns (args, the slots whose output must be exactly zero)."""
    import numpy as np
    import torch

    cap = n_table * bs
    pos = rng.integers(0, cap, batch)
    if edges:
        pos[:5] = [bs - 1, bs, cap, 2 * bs + 3, min(3 * bs + 1, cap - 1)]
    table, n_blocks = _paged_layout(rng, batch, n_table, bs, pos)
    empty = []
    if edges:
        table[3] = n_blocks  # all sentinel: must give zeros
        empty.append(3)
        if n_table > 1:
            table[4, 1] = n_blocks  # a hole inside slot 4's window
    q = _randn(gen, (batch, heads, hd), q_dtype)
    kp = _randn(gen, (n_blocks, bs, kvh, hd), pool_dtype)
    vp = _randn(gen, (n_blocks, bs, kvh, hd), pool_dtype)
    args = (q, kp, vp, torch.as_tensor(table, device="cuda"),
            torch.as_tensor(pos.astype(np.int32), device="cuda"))
    return args, empty


def chunk_case(gen, rng, *, w, heads, kvh, hd, bs, n_table, offset,
               n_valid, q_dtype, pool_dtype, hole: bool = False) -> tuple:
    """Inputs of one ``chunk_attention`` call: one slot's table mapping the
    blocks its ``offset + n_valid`` positions need, sentinel after (and, with
    ``hole``, a sentinel inside the prefix)."""
    import torch

    table, n_blocks = _paged_layout(rng, 1, n_table, bs,
                                    [max(offset + n_valid - 1, 0)])
    if hole:
        table[0, 1] = n_blocks
    q = _randn(gen, (w, heads, hd), q_dtype)
    kp = _randn(gen, (n_blocks, bs, kvh, hd), pool_dtype)
    vp = _randn(gen, (n_blocks, bs, kvh, hd), pool_dtype)
    kc = _randn(gen, (w, kvh, hd), pool_dtype)
    vc = _randn(gen, (w, kvh, hd), pool_dtype)
    return (q, kp, vp, torch.as_tensor(table[0], device="cuda"), kc, vc,
            offset, n_valid)


def _attn_check(label: str, out, ref, rows: int, zero_rows=()) -> float:
    """Hold a kernel's output against its plain version on ``rows``
    leading rows; ``zero_rows`` must be exactly zero."""
    import torch

    torch.cuda.synchronize()
    dtype = str(out.dtype)[6:]
    o, r = out[:rows].float(), ref[:rows].float()
    scale = r.abs().max().item() if rows else 0.0
    err = (o - r).abs().max().item() if rows else 0.0
    tol = ATTN_RTOL[dtype] * scale
    ok = (out.shape == ref.shape and out.dtype == ref.dtype and err <= tol
          and bool(torch.isfinite(out.float()).all()))
    for b in zero_rows:
        ok = ok and not out[b].float().abs().max().item()
    log(f"  parity {label:58s} max_abs_err {err:.3e} tol {tol:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: err {err} > tol {tol}, or non-zero "
                             f"empty rows {list(zero_rows)}, or non-finite")
    return err


def _attn_bound_ms(nbytes: int, flops: int) -> tuple:
    """(least ms, what bounds it): fp32 products on the CUDA cores."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _gathered_lanes(k_pool, v_pool, table):
    """Each slot's logical lane ``(batch, kv_heads, S, hd)`` from the pool,
    for the library yardstick (built before the timed region)."""
    import torch

    n_blocks, bs, kvh, hd = k_pool.shape
    kpos = torch.arange(table.shape[1] * bs, device="cuda")
    rows = (table.long().clamp(max=n_blocks - 1)[:, kpos // bs] * bs
            + kpos % bs)
    gk = k_pool.reshape(-1, kvh, hd)[rows].float().transpose(1, 2)
    gv = v_pool.reshape(-1, kvh, hd)[rows].float().transpose(1, 2)
    valid = table.long()[:, kpos // bs] != n_blocks
    return gk.contiguous(), gv.contiguous(), kpos, valid


def phase_attention(cfg) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.chunk_attention import (chunk_attention,
                                                     chunk_attention_torch)
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_torch)

    log("== phase 4: attention kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    rng = np.random.default_rng(4321)
    heads, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    n_table = MAX_LEN // BLOCK_SIZE
    dtypes = [(qd, pd) for qd in (torch.bfloat16, torch.float32)
              for pd in (torch.float32, torch.bfloat16)]
    # (heads, kvh, hd, bs, n_table): the serving shape, then ragged ones
    shapes = [(heads, kvh, hd, BLOCK_SIZE, n_table)] + [
        (h, k, 64, b, nt) for h, k in ((4, 4), (4, 1), (1, 1))
        for b, nt in ((1, 40), (BLOCK_SIZE, 6))]
    errs = {"paged": 0.0, "chunk": 0.0}
    for qd, pd in dtypes:
        tag = f"q {str(qd)[6:]} pool {str(pd)[6:]}"
        for h, k, d, b, nt in shapes:
            args, empty = decode_case(gen, rng, batch=BATCH, heads=h, kvh=k,
                                      hd=d, bs=b, n_table=nt, q_dtype=qd,
                                      pool_dtype=pd, edges=True)
            err = _attn_check(
                f"decode H={h} kvh={k} hd={d} bs={b} table={nt} {tag}",
                paged_attention(*args), paged_attention_torch(*args),
                BATCH, empty)
            if (h, k, d, b, nt) == shapes[0]:
                errs["paged"] = max(errs["paged"], err)
        main = shapes[0]
        chunk_cases = [(w, off, nv, False) for w in (8, 16, CHUNK)
                       for off, nv in ((0, w), (37, w), (96, w - 3),
                                       (64, 1))]
        chunk_cases += [(CHUNK, 0, 0, False), (16, 48, 16, True)]
        for h, k, d, b, nt in shapes:
            cases = chunk_cases if (h, k, d, b, nt) == main else [
                (8, 0, 8, False), (8, 13, 8, False), (8, 20, 5, True)]
            for w, off, nv, hole in cases:
                args = chunk_case(gen, rng, w=w, heads=h, kvh=k, hd=d, bs=b,
                                  n_table=nt, offset=off, n_valid=nv,
                                  q_dtype=qd, pool_dtype=pd, hole=hole)
                out = chunk_attention(*args)
                label = (f"chunk W={w} off={off} n_valid={nv}"
                         f"{' hole' if hole else ''} H={h} kvh={k} hd={d} "
                         f"bs={b} {tag}")
                err = _attn_check(label, out, chunk_attention_torch(*args),
                                  nv, range(w) if off == nv == 0 else ())
                if (h, k, d, b, nt) == main:
                    errs["chunk"] = max(errs["chunk"], err)

    log("  times at the serving shapes, q bf16, pool fp32 (ms; kernel = "
        "wrapper calls on the stream, graph = the same calls replayed from "
        "a CUDA graph, host work excluded; least = card's bound; lib = "
        "scaled_dot_product_attention on the pre-gathered lane, gather not "
        "timed)")
    # decode: 8 slots at random positions, every table row mapped
    args, _ = decode_case(gen, rng, batch=BATCH, heads=heads, kvh=kvh, hd=hd,
                          bs=BLOCK_SIZE, n_table=n_table,
                          q_dtype=torch.bfloat16, pool_dtype=torch.float32,
                          edges=False)
    q, kp, vp, table, pos = args
    n_keys = int((pos.long() + 1).clamp(max=n_table * BLOCK_SIZE).sum())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * n_keys * kvh * hd * kp.element_size()
              + table.numel() * 4 + pos.numel() * 4)
    flops = 4 * hd * heads * n_keys
    bound, by = _attn_bound_ms(nbytes, flops)
    gk, gv, kpos, mapped = _gathered_lanes(kp, vp, table)
    mask = ((kpos[None, :] <= pos.long()[:, None]) & mapped)[:, None, None]
    qf = q.float()[:, :, None]
    fns = (lambda: paged_attention(*args),
           lambda: paged_attention_torch(*args),
           lambda: F.scaled_dot_product_attention(
               qf, gk, gv, attn_mask=mask, enable_gqa=True))
    ms, plain, lib = (cuda_ms(f) for f in fns)
    dev = graph_ms(fns[0])
    log(f"  time paged_attention B={BATCH} H={heads} kvh={kvh} hd={hd} "
        f"bs={BLOCK_SIZE} keys={n_keys}: kernel {ms:.4f}  graph {dev:.4f}  "
        f"plain {plain:.4f}  lib {lib:.4f}  least {bound:.5f} ({by})")
    paged = dict(ms=ms, device_ms=dev, plain_ms=plain, library_ms=lib,
                 bound_ms=bound, bound_by=by, max_abs_err=errs["paged"],
                 unit=f"one decode launch: B={BATCH} H={heads} kvh={kvh} "
                      f"hd={hd} bs={BLOCK_SIZE} max_table={n_table}, "
                      f"{n_keys} resident keys, q bf16, pool fp32")

    # chunk: a full 32-row chunk resuming at offset 96
    off, w = 96, CHUNK
    args = chunk_case(gen, rng, w=w, heads=heads, kvh=kvh, hd=hd,
                      bs=BLOCK_SIZE, n_table=n_table, offset=off, n_valid=w,
                      q_dtype=torch.bfloat16, pool_dtype=torch.float32)
    q, kp, vp, trow, kc, vc = args[:6]
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * (off + w) * kvh * hd * kp.element_size()
              + trow.numel() * 4)
    flops = 4 * hd * heads * (off * w + w * (w + 1) // 2)
    bound_c, by_c = _attn_bound_ms(nbytes, flops)
    gk, gv, kpos, mapped = _gathered_lanes(kp, vp, trow[None])
    keys = torch.cat([gk, kc.float().transpose(0, 1)[None]], dim=2)
    vals = torch.cat([gv, vc.float().transpose(0, 1)[None]], dim=2)
    j = torch.arange(w, device="cuda")
    cmask = torch.cat([((kpos < off) & mapped[0])[None, :].expand(w, -1),
                       j[None, :] <= j[:, None]], dim=1)[None, None]
    qf = q.float().transpose(0, 1)[None]
    fns = (lambda: chunk_attention(*args),
           lambda: chunk_attention_torch(*args),
           lambda: F.scaled_dot_product_attention(
               qf, keys, vals, attn_mask=cmask, enable_gqa=True))
    ms_c, plain_c, lib_c = (cuda_ms(f) for f in fns)
    dev_c = graph_ms(fns[0])
    log(f"  time chunk_attention W={w} offset={off} H={heads} kvh={kvh} "
        f"hd={hd}: kernel {ms_c:.4f}  graph {dev_c:.4f}  plain {plain_c:.4f}"
        f"  lib {lib_c:.4f}  least {bound_c:.5f} ({by_c})")
    chunk = dict(ms=ms_c, device_ms=dev_c, plain_ms=plain_c,
                 library_ms=lib_c, bound_ms=bound_c, bound_by=by_c,
                 max_abs_err=errs["chunk"],
                 unit=f"one prefill-chunk launch: W={w} at offset {off}, "
                      f"H={heads} kvh={kvh} hd={hd} bs={BLOCK_SIZE} "
                      f"max_table={n_table}, q bf16, pool fp32")
    return {"paged": paged, "chunk": chunk}


# ---- phase 5: serve with every kernel ---------------------------------------


def _engine(model, cfg, **kw):
    from repro_torch.serve import ContinuousEngine

    return ContinuousEngine(model, cfg, batch=BATCH, max_len=MAX_LEN,
                            max_prompt_len=MAX_PROMPT, block_size=BLOCK_SIZE,
                            chunk_size=CHUNK, **kw)


def _warm(engine) -> None:
    import numpy as np

    for plen in engine.buckets:  # first call at each chunk width
        engine.submit(np.zeros(plen, np.int32), max_new_tokens=2)
    engine.run()
    engine.reset_stats()


def _counters():
    from repro_torch.kernels.chunk_attention import chunk_attention
    from repro_torch.kernels.led_matmul import led_matmul
    from repro_torch.kernels.paged_attention import paged_attention

    return {"led_matmul": led_matmul, "paged_attention": paged_attention,
            "chunk_attention": chunk_attention}


def phase_serve_kernels(cfg, model, trace, ref_done) -> dict:
    import numpy as np
    import torch

    from repro_torch.serve.trace import greedy_agreement, latency_stats, replay

    log("== phase 5: serve with every kernel (decode_kernel='cuda', "
        "prefill_kernel='cuda')")
    engine = _engine(model, cfg, decode_kernel="cuda", prefill_kernel="cuda")
    t0 = time.perf_counter()
    _warm(engine)
    log(f"  warm-up {time.perf_counter() - t0:.1f} s")
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    done, wall = replay(engine, trace)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}

    stats = latency_stats(done, wall)
    pstats, kstats = engine.prefill_stats(), engine.kv_stats()
    steps = sum(s["decoded"] for s in engine.step_log)
    chunks = pstats["prefill_chunks"]
    pure_decode = [s["wall_s"] for s in engine.step_log
                   if s["decoded"] and not s["prefill_tokens"]]
    assert len(done) == N_REQUESTS
    for (_, req), comp in zip(trace, done):
        assert comp.finish_reason == "length", comp.finish_reason
        assert len(comp.tokens) == req.max_new_tokens, comp
        assert all(0 <= t < cfg.vocab for t in comp.tokens)
    assert kstats["prefix_hit_tokens"] > 0, kstats
    assert kstats["decode_kernel"] == pstats["prefill_kernel"] == "cuda"
    assert engine.manager.allocator.n_in_use == 0
    layers = cfg.n_layers
    expected = {"led_matmul": 7 * layers * (steps + chunks),
                "paged_attention": layers * steps,
                "chunk_attention": layers * chunks}
    for name, n in launches.items():
        log(f"  {name} launches on the served run {n} (expected "
            f"{expected[name]})")
        assert n > 0 and n == expected[name], (name, n, expected[name])
    agree = greedy_agreement(ref_done, done)
    log(f"  served {stats['requests']} requests, "
        f"{stats['generated_tokens']} tokens in {wall:.2f} s: "
        f"{stats['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{stats['ttft_p50_ms']:.1f} ms p95 {stats['ttft_p95_ms']:.1f} ms, "
        f"latency p50 {stats['latency_p50_ms']:.1f} ms")
    log(f"  decode steps {steps}, mean decode-only step "
        f"{1e3 * float(np.mean(pure_decode)):.1f} ms over "
        f"{len(pure_decode)} steps; prefill chunks {chunks}")
    log(f"  greedy-token agreement with the reference-attention run "
        f"{agree:.3f} (printed, not asserted: bf16 near-ties may flip)")
    divergence_gaps(model, cfg, trace, ref_done, done)
    attention_logits_kernel_vs_reference(model, cfg, trace)
    return {"launches": launches, "stats": stats, "agreement": agree}


class _GapRecorder:
    """Stands in for an engine's model and keeps, for each token the
    engine samples, the gap between the two largest logits, keyed by
    (request uid, token index)."""

    def __init__(self, model, engine):
        self._model, self._engine, self._gaps = model, engine, []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def _keep(self, keys: dict, logits) -> None:
        top = logits.float().topk(2, dim=-1).values
        self._gaps.append((keys, top[:, 0] - top[:, 1]))  # read after the run

    def prefill_chunk(self, tokens, cache, *, slot, **kw):
        logits, cache = self._model.prefill_chunk(tokens, cache, slot=slot,
                                                  **kw)
        if logits is not None:  # a final chunk: its logits give token 0
            uid = self._engine.scheduler.prefilling[slot].uid
            self._keep({0: (uid, 0)}, logits)
        return logits, cache

    def decode(self, token, cache, **kw):
        keys = {b: (s.request.uid, len(s.tokens))
                for b, s in enumerate(self._engine.scheduler.slots)
                if s is not None}
        logits, cache = self._model.decode(token, cache, **kw)
        self._keep(keys, logits[:, 0])
        return logits, cache

    def gaps(self) -> dict:
        out = {}
        for keys, gap in self._gaps:
            values = gap.tolist()
            for row, key in keys.items():
                out[key] = values[row]
        return out


def divergence_gaps(model, cfg, trace, ref_done, done) -> None:
    """Replay the trace once more with the reference attention, keeping
    each sampled token's top-2 logit gap, and print that gap at the first
    token where each request's kernel-run stream parts from it."""
    import numpy as np

    from repro_torch.serve.trace import replay

    engine = _engine(model, cfg)
    _warm(engine)
    recorder = engine.model = _GapRecorder(model, engine)
    again, _ = replay(engine, trace)
    gaps = recorder.gaps()
    same = [c.tokens for c in again] == [c.tokens for c in ref_done]
    every = [gaps[(c.uid, i)] for c in again for i in range(len(c.tokens))]
    log(f"  reference replay with top-2 logit gaps kept: tokens equal to the "
        f"phase-3 run {same}; gap over its {len(every)} sampled tokens: "
        f"median {float(np.median(every)):.4f}, min {min(every):.4f}")
    parted = 0
    for ref, kern in zip(again, done):
        k = next((i for i, (a, b) in enumerate(zip(ref.tokens, kern.tokens))
                  if a != b), None)
        if k is None:
            continue
        parted += 1
        rank = sum(g < gaps[(ref.uid, k)] for g in every) / len(every)
        log(f"  request {ref.uid} parts at token {k} of {len(ref.tokens)}: "
            f"reference top-2 logit gap there {gaps[(ref.uid, k)]:.4f} "
            f"(below it: {rank:.3f} of all sampled tokens)")
    log(f"  {parted} of {len(done)} requests part from the reference run")


def _logits_check(label: str, kern, ref) -> None:
    import torch

    torch.cuda.synchronize()
    kl, rl = kern.float(), ref.float()
    assert torch.isfinite(kl).all()
    err = (kl - rl).abs().max().item()
    scale = rl.abs().max().item()
    same = bool((kl.argmax(-1) == rl.argmax(-1)).all())
    log(f"  {label} logits, attention kernels vs reference on one cache "
        f"state: max_abs_err {err:.4e}, max|logits| {scale:.3f}, tol "
        f"{LOGIT_RTOL * scale:.4e}, argmax equal {same}")
    assert err <= LOGIT_RTOL * scale and same, (label, err, scale, same)


def attention_logits_kernel_vs_reference(model, cfg, trace) -> None:
    """One final prefill chunk (at an offset past a first chunk) and one
    decode step on the same cache state, through the attention kernels and
    through the reference gather; the LED kernel runs in both."""
    import numpy as np
    import torch

    n_blocks = BATCH * (MAX_LEN // BLOCK_SIZE)
    max_table = MAX_LEN // BLOCK_SIZE
    cache = model.init_paged_cache(BATCH, MAX_LEN, cfg, n_blocks=n_blocks,
                                   block_size=BLOCK_SIZE, dtype=torch.float32)
    table = np.arange(n_blocks, dtype=np.int32).reshape(BATCH, max_table)
    cache = cache._replace(table=torch.as_tensor(table, device="cuda"))

    def both(run, cache):
        """run(kernel, cache) twice from the same pool contents."""
        saved = (cache.k.clone(), cache.v.clone())
        out_c, cache_c = run("cuda", cache)
        cache.k.copy_(saved[0])
        cache.v.copy_(saved[1])
        out_r, cache_r = run("reference", cache)
        return out_c, out_r, cache_r

    prompts = [req.prompt for _, req in trace[:BATCH]]
    for slot, prompt in enumerate(prompts):
        plen = len(prompt)
        for off in range(0, plen, CHUNK):
            n = min(CHUNK, plen - off)
            toks = torch.zeros((1, CHUNK), dtype=torch.long, device="cuda")
            toks[0, :n] = torch.as_tensor(prompt[off:off + n], device="cuda")
            p = off + np.arange(CHUNK)
            dst = np.where(p < plen, table[slot, p // BLOCK_SIZE] * BLOCK_SIZE
                           + p % BLOCK_SIZE, n_blocks * BLOCK_SIZE)

            def run(kernel, c, toks=toks, off=off, n=n, dst=dst):
                return model.prefill_chunk(
                    toks, c, slot=slot, offset=off, n_valid=n,
                    dst=torch.as_tensor(dst, device="cuda"),
                    prefill_kernel=kernel)

            if slot == 0 and off + n >= plen:
                assert off > 0, "the checked chunk must have a prefix"
                kern, ref, cache = both(run, cache)
                _logits_check(f"final chunk (offset {off}, {n} rows)", kern,
                              ref)
            else:
                _, cache = run("reference", cache)
    tok = torch.as_tensor([[int(p[-1])] for p in prompts], device="cuda")
    length = cache.length.clone()

    def step(kernel, c):
        return model.decode(tok, c._replace(length=length),
                            decode_kernel=kernel)

    kern, ref, _ = both(step, cache)
    assert kern.shape == (BATCH, 1, cfg.vocab)
    _logits_check("decode step", kern, ref)


# ---- phase 6: fp32 exactness ------------------------------------------------


def phase_fp32_exact(cfg, trace) -> None:
    import torch

    from repro_torch.core import auto_fact
    from repro_torch.models import TransformerLM
    from repro_torch.serve.trace import replay

    cfg32 = cfg.replace(n_layers=FP32_LAYERS, dtype="float32")
    log(f"== phase 6: fp32 exactness, {cfg.name} at full width, "
        f"{FP32_LAYERS} layers, fp32, auto_fact rank {RANK}")
    model = TransformerLM.create(cfg32, seed=1, device="cuda")
    model = auto_fact(model, RANK, solver="svd", exclude=["embed", "lm_head"],
                      gate=False)
    counters = _counters()
    tokens = {}
    for kernel in ("reference", "cuda"):
        engine = _engine(model, cfg32, decode_kernel=kernel,
                         prefill_kernel=kernel)
        for fn in counters.values():
            fn.launches = 0
        done, _ = replay(engine, trace)
        torch.cuda.synchronize()
        tokens[kernel] = [c.tokens for c in done]
        log(f"  {kernel}: {sum(map(len, tokens[kernel]))} tokens, launches "
            + ", ".join(f"{n} {fn.launches}" for n, fn in counters.items()))
        if kernel == "cuda":
            assert counters["paged_attention"].launches > 0
            assert counters["chunk_attention"].launches > 0
    same = sum(a == b for a, b in zip(tokens["reference"], tokens["cuda"]))
    log(f"  greedy tokens equal on {same}/{len(trace)} requests")
    assert tokens["reference"] == tokens["cuda"], "fp32 tokens differ"
    del model
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT}/src/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    cfg = get_config(ARCH)
    buckets = sorted({max(1, CHUNK // 4), max(1, CHUNK // 2), CHUNK})
    phase_device_and_build()
    parity = phase_kernel_parity(cfg, buckets)
    serve = phase_serve(cfg)
    attention = phase_attention(cfg)
    served = phase_serve_kernels(cfg, serve["model"], serve["trace"],
                                 serve["done"])
    del serve["model"]
    phase_fp32_exact(cfg, serve["trace"])
    unit = dict(parity["unit"], bound_by="bytes",
                unit=f"one layer's 7 LED products at decode, M={BATCH}, bf16")
    rows = [("led_matmul", "src/repro/kernels/led_matmul.py:41", unit),
            ("paged_attention", "src/repro/kernels/paged_attention.py:51",
             attention["paged"]),
            ("chunk_attention", "src/repro/kernels/chunk_attention.py:60",
             attention["chunk"])]
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
        "launches": served["launches"][name],
        **{k: m[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms", "unit")},
    } for name, replaces, m in rows]
    log(f"== phase 7: done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
