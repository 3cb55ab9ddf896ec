"""Qwen1.5-110B-class [hf:Qwen]: 80L, d=8192, 64H GQA kv=8, d_ff=49152.

QKV bias (the Qwen1.5 signature), RoPE, SwiGLU.  The largest assigned arch:
TP-heavy deployments dominate its scheduler search space.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_q_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    attn_sharding="heads",      # 64 % 16 == 0
)
