"""Token sampling for the serving paths (counterpart of
``repro.serve.sampling``).

Only greedy decoding is ported.  ``repro.serve.sampling.sample_tokens``
draws Gumbel noise from ``jax.random``; the port's sampled decoding waits
for its ROADMAP item, and the engine refuses ``temperature != 0``."""

from __future__ import annotations

import torch

SAMPLED_ROADMAP_ITEM = "sampled decoding with injected noise"


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab axis -> int32 token ids (the first maximum on
    ties, as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


__all__ = ["greedy_tokens", "SAMPLED_ROADMAP_ITEM"]
