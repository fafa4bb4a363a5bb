"""Models of the port (counterpart of ``repro.models``; dense family)."""

from repro_torch.models.lm import DenseBlock, TransformerLM

__all__ = ["DenseBlock", "TransformerLM"]
