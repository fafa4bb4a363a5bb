"""Chunk-prefill attention: the CUDA kernel, its plain PyTorch version, and
the wrapper that picks between them by device.

Counterpart of ``repro.kernels.chunk_attention.chunk_attention`` (the Pallas
TPU kernel and its wrapper) and ``repro.kernels.ref.chunk_attention_ref``
(the oracle).  The kernel is ``src/repro_torch/csrc/chunk_attention.cu``;
see its header for the design.  The dense-lane entry
(``chunk_attention_dense``) comes with the port's dense KV layout.

* A CPU tensor takes :func:`chunk_attention_torch`, the plain version.
* A CUDA tensor launches the kernel or raises.  There is no fallback.

``chunk_attention.launches`` counts kernel launches.  Nothing else touches
it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._paged import (DTYPE_CODES, NEG_INF, check_inputs,
                                        check_pool)


def chunk_attention_torch(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, table_row: torch.Tensor,
                          k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                          offset: int, n_valid: int) -> torch.Tensor:
    """Plain version (a port of ``ref.chunk_attention_ref``): the slot's
    gathered lane masked ``kpos < offset`` and by sentinel blocks, then the
    chunk's own K/V under ``(j <= r) & (j < n_valid)``; fp32 softmax with a
    guarded division.

    q: (W, heads, hd); k/v_pool: (n_blocks, bs, kv_heads, hd); table_row:
    (max_table,) int with sentinel ``n_blocks``; k/v_chunk: (W, kv_heads,
    hd); offset, n_valid: ints -> (W, heads, hd) in ``q.dtype``."""
    w, heads, hd = q.shape
    n_blocks, bs, kvh, _ = k_pool.shape
    group = heads // kvh
    n_table = table_row.shape[0]
    dev = q.device
    kpos = torch.arange(n_table * bs, device=dev)
    tab = table_row.long()
    safe = tab.clamp(0, n_blocks - 1)  # the sentinel clamps for the gather
    rows = safe[kpos // bs] * bs + kpos % bs
    gk = k_pool.reshape(n_blocks * bs, kvh, hd)[rows].float()
    gv = v_pool.reshape(n_blocks * bs, kvh, hd)[rows].float()
    prefix_valid = (kpos < offset) & (tab[kpos // bs] != n_blocks)
    j = torch.arange(w, device=dev)
    chunk_valid = (j[None, :] <= j[:, None]) & (j[None, :] < n_valid)
    qf = q.float().reshape(w, kvh, group, hd)
    scale = 1.0 / math.sqrt(hd)
    lp = torch.einsum("wkgd,skd->wkgs", qf, gk) * scale
    lc = torch.einsum("wkgd,jkd->wkgj", qf, k_chunk.float()) * scale
    valid = torch.cat([prefix_valid[None, :].expand(w, n_table * bs),
                       chunk_valid], dim=-1)[:, None, None, :]
    logits = torch.where(valid, torch.cat([lp, lc], dim=-1), NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    av = torch.cat([gv, v_chunk.float()], dim=0)
    out = torch.einsum("wkgs,skd->wkgd", p, av) / p.sum(
        -1, keepdim=True).clamp_min(1e-30)
    return out.reshape(w, heads, hd).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("chunk_attention")
    if lib.chunk_attention_launch.argtypes is None:
        lib.chunk_attention_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.chunk_attention_launch.restype = ctypes.c_int
        lib.chunk_attention_error_string.argtypes = [ctypes.c_int]
        lib.chunk_attention_error_string.restype = ctypes.c_char_p
    return lib


def chunk_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, table_row: torch.Tensor,
                    k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                    offset: int, n_valid: int) -> torch.Tensor:
    """One slot's prefill chunk against the paged KV pool.

    q: (W, heads, hd) float32/bfloat16; k/v_pool: (n_blocks, bs, kv_heads,
    hd) float32/bfloat16; table_row: (max_table,) int32, ONE slot's table
    with sentinel ``n_blocks``; k/v_chunk: (W, kv_heads, hd) in the pool's
    dtype; offset: absolute position of chunk row 0; n_valid: real rows.
    Both are host ints.  Returns (W, heads, hd) in ``q.dtype``; rows
    ``>= n_valid`` are padding and carry no contract."""
    if q.ndim != 3:
        raise ValueError(f"chunk_attention: q must be (W, heads, hd), got "
                         f"{tuple(q.shape)}")
    check_pool("chunk_attention", q, k_pool, v_pool)
    w, heads, hd = q.shape
    n_blocks, bs, kvh, _ = k_pool.shape
    if k_chunk.shape != (w, kvh, hd) or v_chunk.shape != (w, kvh, hd):
        raise ValueError(
            f"chunk_attention: chunk K/V must be (W, kv_heads, head_dim) = "
            f"{(w, kvh, hd)}; got k {tuple(k_chunk.shape)}, v "
            f"{tuple(v_chunk.shape)}")
    if table_row.ndim != 1:
        raise ValueError(f"chunk_attention: table_row must be ONE slot's "
                         f"table (max_table,); got {tuple(table_row.shape)}")
    offset, n_valid = int(offset), int(n_valid)
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool, table_row=table_row,
                   k_chunk=k_chunk, v_chunk=v_chunk)
    check_inputs("chunk_attention", tensors)
    if not q.is_cuda:
        return chunk_attention_torch(q, k_pool, v_pool, table_row, k_chunk,
                                     v_chunk, offset, n_valid)
    q, table_row = q.contiguous(), table_row.contiguous()
    k_chunk, v_chunk = k_chunk.contiguous(), v_chunk.contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.chunk_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table_row.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
            out.data_ptr(), w, heads, kvh, hd, bs, n_blocks,
            table_row.shape[0], offset, n_valid, DTYPE_CODES[q.dtype],
            DTYPE_CODES[k_pool.dtype], stream)
    if code != 0:
        raise RuntimeError(
            f"chunk_attention kernel launch failed for q {tuple(q.shape)} "
            f"pool {tuple(k_pool.shape)} {q.dtype}/{k_pool.dtype}: "
            f"{lib.chunk_attention_error_string(code).decode()}")
    chunk_attention.launches += 1
    return out


chunk_attention.launches = 0

__all__ = ["chunk_attention", "chunk_attention_torch"]
