"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8.
[arXiv:2501.kimi2; unverified, paper-table]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, n_shared=1, capacity_factor=1.25,
    note="trillion-param MoE; d_ff is per-expert; 1 shared expert",
)
