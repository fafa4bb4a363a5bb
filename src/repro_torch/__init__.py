"""repro_torch — the PyTorch/CUDA port of ``repro`` (Greenformer serving).

Mirrors ``repro`` module for module (``repro_torch.nn.attention`` is the
counterpart of ``repro.nn.attention``) and imports neither JAX nor
anything of ``repro``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; every Pallas kernel of the path is a hand-written
CUDA kernel under ``csrc/`` with its plain PyTorch version beside it.

fp32 products are computed in fp32, as in the JAX package: TF32 is turned
off for matmuls and cuDNN when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
