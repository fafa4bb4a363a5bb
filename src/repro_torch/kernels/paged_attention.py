"""Paged-attention decode: the CUDA kernel, its plain PyTorch version, and
the wrapper that picks between them by device.

Counterpart of ``repro.kernels.paged_attention`` (the Pallas TPU kernel and
its wrapper) and ``repro.kernels.ref.paged_attention_ref`` (the oracle).
The kernel is ``src/repro_torch/csrc/paged_attention.cu``; see its header
for the design.

* A CPU tensor takes :func:`paged_attention_torch`, the plain version.
* A CUDA tensor launches the kernel or raises.  There is no fallback.

``paged_attention.launches`` counts kernel launches.  Nothing else touches
it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._paged import (DTYPE_CODES, NEG_INF, check_inputs,
                                        check_pool)


def paged_attention_torch(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, table: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """Plain version (a port of ``ref.paged_attention_ref``): gather every
    slot's lane from the pool, mask ``kpos > pos[b]`` and sentinel blocks,
    fp32 softmax with a guarded division (a fully masked slot gives zeros).

    q: (batch, heads, hd); k/v_pool: (n_blocks, bs, kv_heads, hd); table:
    (batch, max_table) int with sentinel ``n_blocks``; pos: (batch,) int
    -> (batch, heads, hd) in ``q.dtype``."""
    batch, heads, hd = q.shape
    n_blocks, bs, kvh, _ = k_pool.shape
    group = heads // kvh
    n_table = table.shape[1]
    kpos = torch.arange(n_table * bs, device=q.device)
    tab = table.long()
    safe = tab.clamp(0, n_blocks - 1)  # the sentinel clamps for the gather
    rows = safe[:, kpos // bs] * bs + (kpos % bs)[None, :]
    gk = k_pool.reshape(n_blocks * bs, kvh, hd)[rows].float()
    gv = v_pool.reshape(n_blocks * bs, kvh, hd)[rows].float()
    valid = ((kpos[None, :] <= pos.long()[:, None])
             & (tab[:, kpos // bs] != n_blocks))  # (batch, S)
    qf = q.float().reshape(batch, kvh, group, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, gk) / math.sqrt(hd)
    mask = valid[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", p, gv) / p.sum(
        -1, keepdim=True).clamp_min(1e-30)
    return out.reshape(batch, heads, hd).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    if lib.paged_attention_launch.argtypes is None:
        lib.paged_attention_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, table: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """Single-query attention against the paged KV pool.

    q: (batch, heads, hd) float32/bfloat16; k/v_pool: (n_blocks, bs,
    kv_heads, hd) float32/bfloat16; table: (batch, max_table) int32 with
    sentinel ``n_blocks``; pos: (batch,) int32, keys at ``kpos <= pos[b]``.
    Returns (batch, heads, hd) in ``q.dtype``.  The kernel reads ``pos`` and
    ``table`` on the card: no host synchronisation."""
    if q.ndim != 3:
        raise ValueError(f"paged_attention: q must be (batch, heads, hd), "
                         f"got {tuple(q.shape)}")
    check_pool("paged_attention", q, k_pool, v_pool)
    batch = q.shape[0]
    if table.ndim != 2 or table.shape[0] != batch or pos.shape != (batch,):
        raise ValueError(f"paged_attention: table {tuple(table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {batch}")
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool, table=table, pos=pos)
    check_inputs("paged_attention", tensors)
    if not q.is_cuda:
        return paged_attention_torch(q, k_pool, v_pool, table, pos)
    q = q.contiguous()
    table, pos = table.contiguous(), pos.contiguous()
    _, heads, hd = q.shape
    n_blocks, bs, kvh, _ = k_pool.shape
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), pos.data_ptr(), out.data_ptr(), batch, heads,
            kvh, hd, bs, n_blocks, table.shape[1], DTYPE_CODES[q.dtype],
            DTYPE_CODES[k_pool.dtype], stream)
    if code != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed for q {tuple(q.shape)} "
            f"pool {tuple(k_pool.shape)} {q.dtype}/{k_pool.dtype}: "
            f"{lib.paged_attention_error_string(code).decode()}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

__all__ = ["paged_attention", "paged_attention_torch"]
