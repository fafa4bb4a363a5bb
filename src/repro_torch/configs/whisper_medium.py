"""whisper-medium [audio] — encoder-decoder, conv frontend stubbed:
input_specs() provides precomputed frame embeddings. [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab=51865, max_positions=65536,
    note="enc-dec; modality frontend is a stub (precomputed frame embeddings); "
         "LayerNorm+GeLU, learned positions",
)
