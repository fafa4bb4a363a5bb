"""Serving stack of the port (counterpart of ``repro.serve``): the paged,
greedy ``ContinuousEngine`` path."""

from repro_torch.nn.attention import UnsupportedCacheError
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.paging import (BlockAllocator, PagedCacheManager,
                                      PrefixCache, chain_keys)
from repro_torch.serve.sampling import greedy_tokens
from repro_torch.serve.scheduler import Completion, Request, Scheduler
from repro_torch.serve.trace import (bench_trace, format_kv_stats,
                                     format_prefill_stats, format_stats,
                                     greedy_agreement, latency_stats,
                                     make_trace, replay, stall_stats)

__all__ = ["ContinuousEngine", "UnsupportedCacheError", "BlockAllocator",
           "PagedCacheManager", "PrefixCache", "chain_keys", "greedy_tokens",
           "Completion", "Request", "Scheduler", "bench_trace",
           "format_kv_stats", "format_prefill_stats", "format_stats",
           "greedy_agreement", "latency_stats", "make_trace", "replay",
           "stall_stats"]
