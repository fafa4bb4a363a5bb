"""deepseek-moe-16b [moe] — fine-grained MoE: 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared=2, capacity_factor=1.25,
    note="fine-grained experts (d_ff=1408 each); MHA attention",
)
