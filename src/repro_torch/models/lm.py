"""Decoder-only transformer LM (counterpart of ``repro.models.lm``; the
dense family on the paged serving path).

JAX stacks the layers on a leading axis and scans over them; here the
layers are an ``nn.ModuleList`` and a Python loop walks them.  The paged
KV pool keeps JAX's layer-stacked layout ``(n_layers, n_blocks,
block_size, kv_heads, head_dim)`` and each layer works on its view.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.nn.attention import (Attention, PagedKVCache,
                                      UnsupportedCacheError)
from repro_torch.nn.embedding import Embedding
from repro_torch.nn.linear import Linear
from repro_torch.nn.mlp import SwiGLU
from repro_torch.nn.norm import RMSNorm


def torch_dtype(name: str) -> torch.dtype:
    """``ArchConfig.dtype`` (a numpy-style name) as a torch dtype."""
    return getattr(torch, name)


class DenseBlock(nn.Module):
    def __init__(self, attn_norm: RMSNorm, attn: Attention,
                 mlp_norm: RMSNorm, mlp: SwiGLU):
        super().__init__()
        self.attn_norm = attn_norm
        self.attn = attn
        self.mlp_norm = mlp_norm
        self.mlp = mlp

    @staticmethod
    def create(gen: torch.Generator, cfg: ArchConfig) -> "DenseBlock":
        dt, dev = torch_dtype(cfg.dtype), gen.device
        return DenseBlock(
            attn_norm=RMSNorm(cfg.d_model, dtype=dt, device=dev),
            attn=Attention.create(
                gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                rope_theta=cfg.rope_theta, dtype=dt),
            mlp_norm=RMSNorm(cfg.d_model, dtype=dt, device=dev),
            mlp=SwiGLU.create(gen, cfg.d_model, cfg.d_ff, dtype=dt),
        )

    def decode(self, x, cache: PagedKVCache, decode_kernel="reference"):
        a, cache = self.attn.decode(self.attn_norm(x), cache,
                                    decode_kernel=decode_kernel)
        x = x + a
        x = x + self.mlp(self.mlp_norm(x))
        return x, cache

    def prefill_chunk(self, x, cache: PagedKVCache, **kw):
        a, cache = self.attn.prefill_chunk(self.attn_norm(x), cache, **kw)
        x = x + a
        x = x + self.mlp(self.mlp_norm(x))
        return x, cache


class TransformerLM(nn.Module):
    def __init__(self, embed: Embedding, blocks: nn.ModuleList,
                 final_norm: RMSNorm, lm_head: Optional[Linear]):
        super().__init__()
        self.embed = embed
        self.blocks = blocks
        self.final_norm = final_norm
        self.lm_head = lm_head  # None => tied embeddings

    @property
    def n_layers(self) -> int:
        return len(self.blocks)

    @staticmethod
    def create(cfg: ArchConfig, *, seed: int = 0,
               device=None) -> "TransformerLM":
        """Random init from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` (``cuda`` unless the caller asks otherwise)."""
        if cfg.family != "dense" or cfg.window or cfg.attn_chunk:
            raise UnsupportedCacheError(
                f"{cfg.name}: the port builds dense global-attention "
                f"decoders only (family {cfg.family!r}, window "
                f"{cfg.window}, attn_chunk {cfg.attn_chunk})",
                roadmap_item="port the other families")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = torch_dtype(cfg.dtype)
        embed = Embedding.create(gen, cfg.vocab, cfg.d_model, dtype=dt)
        blocks = nn.ModuleList(DenseBlock.create(gen, cfg)
                               for _ in range(cfg.n_layers))
        lm_head = (None if cfg.tie_embeddings else
                   Linear.create(gen, cfg.d_model, cfg.vocab, dtype=dt))
        return TransformerLM(embed, blocks,
                             RMSNorm(cfg.d_model, dtype=dt, device=dev),
                             lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def _head(self, x):
        return self.embed.attend(x) if self.lm_head is None else self.lm_head(x)

    # -- serving --------------------------------------------------------------

    def cache_kind(self, cfg: ArchConfig) -> str:
        """Capability probe for ``ContinuousEngine``: global-attention
        configs are ``"kv"``, sliding-window configs ``"ring"``."""
        return "ring" if cfg.window else "kv"

    def init_paged_cache(self, batch: int, max_len: int, cfg: ArchConfig, *,
                         n_blocks: int, block_size: int,
                         dtype=torch.bfloat16) -> PagedKVCache:
        """Shared KV block pool + per-slot block tables on the model's
        device.  Pool k/v carry a leading layer dim; the block table is
        layer-invariant and stored once.  Unmapped entries hold the
        sentinel ``n_blocks``."""
        if cfg.window:
            raise UnsupportedCacheError(
                "paged KV cache requires global attention (cfg.window == 0)",
                roadmap_item="port the other families")
        kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        max_table = -(-max_len // block_size)
        dev = self.device
        shape = (self.n_layers, n_blocks, block_size, kvh, hd)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            table=torch.full((batch, max_table), n_blocks, dtype=torch.int32,
                             device=dev),
            length=torch.zeros((self.n_layers, batch), dtype=torch.int32,
                               device=dev),
        )

    def _layers(self, x, cache: PagedKVCache, step):
        """Run ``step(block, x, layer_cache)`` over the layers; each layer
        sees its view of the pool and its own length row."""
        lengths = []
        for i, blk in enumerate(self.blocks):
            x, c = step(blk, x, PagedKVCache(cache.k[i], cache.v[i],
                                             cache.table, cache.length[i]))
            lengths.append(c.length)
        return x, cache._replace(length=torch.stack(lengths))

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, cache: PagedKVCache, *,
                      slot: int, offset: int, n_valid: int,
                      dst: torch.Tensor, need_logits: bool = True,
                      prefill_kernel: str = "reference"):
        """Consume one bucket-padded prompt chunk for slot ``slot``.

        ``tokens``: (1, W) int — ``n_valid`` real tokens starting at
        absolute position ``offset``, right-padded to the bucket width W;
        ``dst`` carries the flat pool row per chunk position (sentinel for
        padding/cached-prefix positions).  Returns ``(logits (1, vocab) at
        the chunk's last valid position, cache)``, or ``(None, cache)``
        with ``need_logits=False`` (mid-prompt chunks skip the head).
        ``prefill_kernel`` picks each layer's chunk attention
        (``"reference"`` gather or the ``"cuda"`` kernel)."""
        x = self.embed(tokens)
        x, cache = self._layers(
            x, cache, lambda blk, h, c: blk.prefill_chunk(
                h, c, slot=slot, offset=offset, n_valid=n_valid, dst=dst,
                prefill_kernel=prefill_kernel))
        if not need_logits:
            return None, cache
        last = x[:, n_valid - 1:n_valid]
        return self._head(self.final_norm(last))[:, 0], cache

    @torch.no_grad()
    def decode(self, token: torch.Tensor, cache: PagedKVCache,
               decode_kernel: str = "reference"):
        """token: (batch, s) -> logits (batch, s, vocab) + updated cache.
        ``decode_kernel`` picks each layer's attention (``"reference"``
        gather or the ``"cuda"`` paged-attention kernel)."""
        x = self.embed(token)
        x, cache = self._layers(
            x, cache,
            lambda blk, h, c: blk.decode(h, c, decode_kernel=decode_kernel))
        return self._head(self.final_norm(x)), cache
