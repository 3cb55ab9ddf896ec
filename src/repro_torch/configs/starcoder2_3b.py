"""StarCoder2-3B [arXiv:2402.19173]: 30L, d=3072, 24H GQA kv=2, d_ff=12288.

Plain (non-gated) GeLU MLP with biases, RoPE.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_q_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    mlp_variant="gelu",
    qkv_bias=True,
    mlp_bias=True,
    rope_theta=999_999.4,
    norm_eps=1e-5,
    tie_embeddings=True,
    attn_sharding="pad",        # 24 -> 32 on TP=16
)
