"""Yi-9B [arXiv:2403.04652]: llama-arch, 48L, d=4096, 32H GQA kv=4, d_ff=11008."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_q_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64_000,
    rope_theta=10_000.0,
    tie_embeddings=False,
    attn_sharding="heads",
)
