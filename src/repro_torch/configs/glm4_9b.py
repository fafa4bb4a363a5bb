"""glm4-9b [dense] — RoPE + GQA. [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab=151552,
    note="GQA kv=2",
)
