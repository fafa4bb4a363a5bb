#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing its numbers; any failure raises and the script exits
non-zero:

1. device and build — the card's name and power limit, torch and CUDA
   versions, and the LED kernel built from ``src/repro_torch/csrc``;
2. kernel parity — the LED kernel against its plain PyTorch version at
   every shape the serving path gives it and at ragged shapes, in bf16 and
   fp32, then CUDA-event times of the kernel, the plain version and
   ``torch.matmul(torch.matmul(x, a), b)`` (a yardstick the port never
   calls) beside the card's least time for the same work;
3. serve — qwen2.5-3b at full width and depth in bf16 from a seeded
   generator, ``auto_fact``-ed (rank 0.5, embed and lm_head excluded, gate
   off), served greedily through ``ContinuousEngine`` on a seeded trace
   with a shared prefix; checks every completion, the prefix hits and the
   kernel's launch count on that run, and holds one decode step's logits
   through the kernel against the plain version on the same cache state;
4. the kernel summary line, the card line, and the result line.

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
    path = _build.build("led_matmul")
    log(f"built {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{_build.build_seconds['led_matmul']:.2f} s)")


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
    unit_plain = cuda_ms(lambda: [led_matmul_torch(*t) for t in unit])
    unit_lib = cuda_ms(lambda: [torch.matmul(torch.matmul(x, a), b)
                                for x, a, b in unit])
    unit_bound = sum(led_bound_ms(BATCH, *shapes[p], "bfloat16")[0]
                     for p in shapes)
    log(f"  decode layer (7 products, M={BATCH}, bf16): kernel "
        f"{unit_ms:.4f} ms  plain {unit_plain:.4f} ms  lib {unit_lib:.4f} ms"
        f"  least {unit_bound:.4f} ms (bytes)")
    return {"per_shape": per_shape, "unit": dict(
        ms=unit_ms, plain_ms=unit_plain, library_ms=unit_lib,
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
            "stats": stats, "logits_err": logits_err}


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
    unit = parity["unit"]
    kernels = [{
        "name": "led_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/led_matmul.cu",
        "replaces": "src/repro/kernels/led_matmul.py:41",
        "launches": serve["launches"], "max_abs_err": unit["max_abs_err"],
        "ms": unit["ms"], "plain_ms": unit["plain_ms"],
        "bound_ms": unit["bound_ms"], "bound_by": "bytes",
        "library_ms": unit["library_ms"],
        "unit": f"one layer's 7 LED products at decode, M={BATCH}, bf16",
    }]
    log(f"== phase 4: done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
