"""What the two paged-attention wrappers (``paged_attention``,
``chunk_attention``) share: the mask fill value, the dtype codes of their
CUDA launchers, and the checks they make before a launch."""

from __future__ import annotations

import torch

# the port's mask fill value (also repro_torch.nn.attention.NEG_INF); equal
# to the JAX package's repro.kernels.ref.NEG_INF (a test pins it)
NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256  # MAX_HD in csrc/attention_common.cuh
INDEX_ARGS = ("table", "table_row", "pos")


def check_pool(name: str, q: torch.Tensor, k_pool: torch.Tensor,
               v_pool: torch.Tensor) -> None:
    """q's last two axes (heads, hd) against a (n_blocks, bs, kv_heads, hd)
    pool pair."""
    if (k_pool.ndim != 4 or v_pool.shape != k_pool.shape
            or k_pool.shape[-1] != q.shape[-1]):
        raise ValueError(f"{name}: pool/query shape mismatch: q "
                         f"{tuple(q.shape)}, k {tuple(k_pool.shape)}, v "
                         f"{tuple(v_pool.shape)}")
    if q.shape[-2] % k_pool.shape[2]:
        raise ValueError(f"{name}: heads {q.shape[-2]} not a multiple of "
                         f"kv_heads {k_pool.shape[2]}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {q.shape[-1]}")


def check_inputs(name: str, tensors: dict) -> None:
    """What a kernel takes beyond shapes: every tensor on q's device, q and
    the pool in float32 or bfloat16, every other K/V tensor in the pool's
    dtype, int32 indices, and a contiguous pool (a layer's view of the
    stacked pool is; the wrapper never copies the pool).  Checked on the
    CPU too, so that the plain version is held to the kernel's contract."""
    dev = tensors["q"].device
    bad = [k for k, t in tensors.items() if t.device != dev]
    if bad:
        raise ValueError(f"{name}: {bad} not on {dev}, the device of q")
    pool_dtype = tensors["k_pool"].dtype
    if tensors["q"].dtype not in DTYPE_CODES or pool_dtype not in DTYPE_CODES:
        raise TypeError(f"{name} kernel takes q and the pool in float32 or "
                        f"bfloat16; got q {tensors['q'].dtype}, pool "
                        f"{pool_dtype}")
    for key, t in tensors.items():
        if key in INDEX_ARGS:
            if t.dtype != torch.int32:
                raise TypeError(f"{name}: {key} must be int32, got {t.dtype}")
        elif key != "q" and t.dtype != pool_dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, the pool is "
                            f"{pool_dtype}")
    for key in ("k_pool", "v_pool"):
        if not tensors[key].is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
