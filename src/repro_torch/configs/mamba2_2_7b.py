"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    supports_long_context=True,
    note="attention-free; O(1)-state decode => long_500k applicable",
)
