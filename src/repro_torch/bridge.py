"""Carry weights between the JAX package and the port.

The JAX package names every parameter by a dotted path
(``repro.nn.module.named_parameters``) and stacks the layers on a leading
axis (``blocks.attn.q_proj.weight`` is ``(n_layers, in, out)``).  The port
keeps the same layout inside each layer, ``Linear.weight`` ``(in, out)``,
``LED.A`` ``(in, r)`` and ``LED.B`` ``(r, out)``, and holds its layers in an
``nn.ModuleList``.  :func:`load_params` slices the stacked axis into
``blocks[i]``; :func:`named_parameters` stacks it back, so the two names
and shapes match one for one.

bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` rejects; they are recognised by their dtype name and
moved as their 16-bit patterns, without importing ml_dtypes.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import TransformerLM
from repro_torch.nn.linear import LED


def to_tensor(arr, device=None) -> torch.Tensor:
    """A numpy (or numpy-convertible) array as a torch tensor that owns its
    memory; bfloat16 arrays keep their exact bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).copy()
        t = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t if device is None else t.to(device)


def _split(path: str) -> Tuple[str, str]:
    module, _, leaf = path.rpartition(".")
    return module, leaf


def load_params(model: TransformerLM, params: Mapping[str, np.ndarray]
                ) -> TransformerLM:
    """Fill ``model`` in place from JAX dotted-path arrays.

    A JAX ``LED`` (leaves ``A``/``B``) turns the port's module at that path
    into an ``LED`` with ``fuse="auto"``; a ``Linear`` stays one.  Every
    parameter of the port model must be covered."""
    by_module: dict = {}
    for path, arr in params.items():
        module, leaf = _split(path)
        by_module.setdefault(module, {})[leaf] = arr
    dev = model.device
    seen = set()
    for module, leaves in by_module.items():
        if module.startswith("blocks."):
            rest = module[len("blocks."):]
            targets = [(f"blocks.{i}.{rest}", i)
                       for i in range(model.n_layers)]
        else:
            targets = [(module, None)]
        for mpath, i in targets:
            vals = {k: to_tensor(v if i is None else np.asarray(v)[i], dev)
                    for k, v in leaves.items()}
            parent_path, name = _split(mpath)
            parent = model.get_submodule(parent_path) if parent_path else model
            if "A" in vals:
                setattr(parent, name, LED(vals["A"], vals["B"],
                                          vals.get("bias")))
                seen.update(f"{mpath}.{k}" for k in vals)
                continue
            mod = getattr(parent, name)
            for k, t in vals.items():
                p = getattr(mod, k)
                if p is None or p.shape != t.shape:
                    raise ValueError(
                        f"{mpath}.{k}: port has "
                        f"{None if p is None else tuple(p.shape)}, JAX "
                        f"{tuple(t.shape)}")
                setattr(mod, k, nn.Parameter(t, requires_grad=False))
                seen.add(f"{mpath}.{k}")
    missing = [n for n, _ in model.named_parameters() if n not in seen]
    if missing:
        raise ValueError(f"JAX params do not cover {missing[:5]} "
                         f"({len(missing)} missing)")
    return model


def from_jax(params: Mapping[str, np.ndarray], cfg: ArchConfig, *,
             device=None) -> TransformerLM:
    """A port ``TransformerLM`` for ``cfg`` holding the JAX ``params``
    (dense or factorized), on ``device`` (``cuda`` unless asked)."""
    model = TransformerLM.create(cfg, device=device)
    return load_params(model, params)


def named_parameters(model: TransformerLM
                     ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(JAX dotted path, tensor)`` pairs, the per-layer tensors stacked
    on a leading axis as the JAX package stacks them."""
    stacked: dict = {}
    for name, p in model.named_parameters():
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            stacked.setdefault(f"blocks.{rest}", {})[int(i)] = p
        else:
            yield name, p.detach()
    for name, per_layer in stacked.items():
        yield name, torch.stack([per_layer[i].detach()
                                 for i in range(len(per_layer))])


__all__ = ["from_jax", "load_params", "named_parameters", "to_tensor"]
