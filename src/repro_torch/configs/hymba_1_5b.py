"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer.
[arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    ssm_state=16, ssm_head_dim=64, window=1024,
    supports_long_context=True,
    note="parallel attn+SSM heads; SWA ring-buffer KV (window=1024) + O(1) "
         "SSM state => long_500k applicable. Simplifications vs paper: no "
         "meta tokens, all layers SWA (global context via the SSM path)",
)
