"""Granite-3.0 MoE [hf:ibm-granite]: 32L, d=1536, 24H GQA kv=8, 40 experts top-8.

Assignment-sheet discrepancy ("MoE 40e top-8" vs trailing "32 experts"): we
implement the structured field, 40 experts (matches granite-3.0-3b-a800m).
40 % 16 != 0, so expert sharding falls back to expert-TP (shard each
expert's d_ff=512 across the model axis).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_q_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    rope_theta=10_000.0,
    tie_embeddings=True,
    expert_sharding="tp",
    attn_sharding="pad",        # 24 heads -> pad to 32 on TP=16
)
