"""Fused LED matmul ``y = (x @ A) @ B``: the CUDA kernel, its plain
PyTorch version, and the wrapper that picks between them by device.

Counterpart of ``repro.kernels.led_matmul`` (the Pallas TPU kernel),
``repro.kernels.ops.led_matmul`` (the wrapper) and
``repro.kernels.ref.led_matmul_ref`` (the oracle).  The kernel is
``src/repro_torch/csrc/led_matmul.cu``; see its header for the design.

* A CPU tensor takes :func:`led_matmul_torch`, the plain version.
* A CUDA tensor launches the kernel or raises.  There is no fallback.

``led_matmul.launches`` counts kernel launches.  Nothing else touches it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def led_matmul_torch(x: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 ``(x @ A) @ B``, rounded once to ``x.dtype``.

    x: (..., K); a: (..., K, R); b: (..., R, N) -> (..., N).  a/b may carry
    leading stack axes, which ``matmul`` broadcasting pairs with x's leading
    axes (mirrors ``repro.kernels.ref.led_matmul_ref``)."""
    t = torch.matmul(x.float(), a.float())
    return torch.matmul(t, b.float()).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("led_matmul")
    if lib.led_matmul_launch.argtypes is None:
        lib.led_matmul_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.led_matmul_launch.restype = ctypes.c_int
        lib.led_matmul_error_string.argtypes = [ctypes.c_int]
        lib.led_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _launch_2d(x2: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    m, k = x2.shape
    r, n = b.shape
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    lib = _lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        code = lib.led_matmul_launch(
            x2.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
            m, k, r, n, _DTYPE_CODES[x2.dtype], stream)
    if code != 0:
        raise RuntimeError(
            f"led_matmul kernel launch failed for M={m} K={k} R={r} N={n} "
            f"{x2.dtype}: {lib.led_matmul_error_string(code).decode()}")
    led_matmul.launches += 1
    return y


def led_matmul(x: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Fused ``(x @ A) @ B``. x: (..., K); a: (K, R); b: (R, N).

    On the card the factors are 2-D, as every port layer holds them (the
    JAX wrapper also vmaps over layer-stacked factors; the plain version
    does, for a CPU tensor)."""
    if not x.is_cuda:
        return led_matmul_torch(x, a, b)
    if not (a.is_cuda and b.is_cuda) or not (x.device == a.device == b.device):
        raise ValueError("led_matmul: x, a and b must share one CUDA device")
    if x.dtype not in _DTYPE_CODES or a.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(
            f"led_matmul kernel takes float32 or bfloat16 with one dtype for "
            f"x, a and b; got {x.dtype}, {a.dtype}, {b.dtype}")
    if a.shape[-1] != b.shape[-2] or x.shape[-1] != a.shape[-2]:
        raise ValueError(f"led_matmul shapes do not chain: x {tuple(x.shape)} "
                         f"a {tuple(a.shape)} b {tuple(b.shape)}")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"led_matmul kernel takes 2-D factors, got a "
                         f"{tuple(a.shape)} b {tuple(b.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = _launch_2d(x2, a.contiguous(), b.contiguous())
    return y.reshape(*lead, b.shape[-1])


led_matmul.launches = 0

__all__ = ["led_matmul", "led_matmul_torch"]
