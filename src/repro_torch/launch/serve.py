"""Serving driver of the port: replay a trace through ``ContinuousEngine``
(counterpart of the offline path of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --factorize [--rank 0.5 --solver svd] [--device cpu --reduced] \\
        [--decode-kernel cuda --prefill-kernel cuda]

Builds the model from a seeded generator on ``--device`` (``cuda`` unless
asked), optionally factorizes it with ``auto_fact`` (embed and lm_head
excluded, r_max gate off, as the JAX driver does), and replays a Poisson
arrival trace of variable-length prompts through the paged, chunked,
greedy engine, with the attention that ``--decode-kernel`` and
``--prefill-kernel`` name (the ``reference`` gather by default, or the
``cuda`` kernels).  Prints tok/s, latency and TTFT percentiles, the KV
pool's occupancy and the prefill profile.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.configs import get_config
from repro_torch.core import auto_fact
from repro_torch.models import TransformerLM
from repro_torch.serve.trace import (bench_trace, format_kv_stats,
                                     format_prefill_stats, format_stats,
                                     make_trace)

MIN_PROMPT = 4
LOAD = 0.5  # expected request arrivals per decode step


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="paper-tiny")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=8,
                   help="decode slots (requests in flight)")
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--max-prompt-len", type=int, default=64)
    p.add_argument("--n-requests", type=int, default=32)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--shared-prefix", type=int, default=0,
                   help="common system-prompt tokens prepended to every "
                        "request (prefix-cache workload)")
    p.add_argument("--block-size", type=int, default=16,
                   help="tokens per KV block")
    p.add_argument("--chunk-size", type=int, default=32,
                   help="max prompt tokens consumed per prefill chunk")
    p.add_argument("--factorize", action="store_true",
                   help="serve the auto_fact-factorized model (rank from "
                        "--rank, embed/lm_head excluded, r_max gate off)")
    p.add_argument("--rank", type=float, default=0.5,
                   help="factorization rank as a ratio of min(m, n)")
    p.add_argument("--solver", default="svd", choices=("svd", "random"))
    p.add_argument("--decode-kernel", default="reference",
                   choices=("reference", "cuda"),
                   help="paged decode attention: the reference gather or "
                        "the CUDA paged-attention kernel")
    p.add_argument("--prefill-kernel", default="reference",
                   choices=("reference", "cuda"),
                   help="chunked prefill attention: the reference gather "
                        "or the CUDA chunk-attention kernel")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run there)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if not 0 <= args.shared_prefix <= args.max_prompt_len - MIN_PROMPT:
        p.error(f"--shared-prefix must be in [0, {args.max_prompt_len} - "
                f"{MIN_PROMPT}] so prompts still fit --max-prompt-len")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = TransformerLM.create(cfg, seed=args.seed, device=args.device)
    print(f"# {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype} on {model.device}")
    label = "dense"
    if args.factorize:
        model, report = auto_fact(model, args.rank, solver=args.solver,
                                  exclude=["embed", "lm_head"], gate=False,
                                  return_report=True)
        print(report.summary())
        label = "factorized"
    trace = make_trace(args.n_requests, seed=args.seed, load=LOAD,
                       min_prompt=MIN_PROMPT,
                       max_prompt=args.max_prompt_len - args.shared_prefix,
                       min_new=4, max_new=args.max_new, vocab=cfg.vocab,
                       shared_prefix=args.shared_prefix)
    _, stats = bench_trace(model, cfg, trace, batch=args.batch,
                           max_len=args.max_len,
                           max_prompt_len=args.max_prompt_len,
                           block_size=args.block_size,
                           chunk_size=args.chunk_size,
                           decode_kernel=args.decode_kernel,
                           prefill_kernel=args.prefill_kernel)
    print(format_stats(label, stats))
    print(format_kv_stats(label, stats))
    print(format_prefill_stats(label, stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
