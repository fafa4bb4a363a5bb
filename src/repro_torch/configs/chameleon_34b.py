"""chameleon-34b [vlm] — early-fusion; VQ image tokens share the text
vocabulary, so the backbone is a dense decoder LM; the image tokenizer
frontend is a stub per the assignment. [arXiv:2405.09818; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=65536,
    note="early-fusion VLM; VQ image tokens are ordinary vocab ids (stub)",
)
