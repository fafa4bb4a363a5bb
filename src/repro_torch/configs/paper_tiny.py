"""The paper's own showcase scale: a small transformer for the Fig. 2
use-case benchmarks (trainable on CPU in minutes)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paper-tiny", family="dense",
    n_layers=4, d_model=256, n_heads=8, n_kv_heads=8, head_dim=32,
    d_ff=1024, vocab=256, dtype="float32",
    note="paper Fig.2 reproduction scale",
)
