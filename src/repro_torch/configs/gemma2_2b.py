"""Gemma2-2B [arXiv:2408.00118]: 26L, d=2304, 8H GQA kv=4, d_ff=9216.

Alternating local(4096)/global attention, attn softcap 50, final softcap 30,
GeGLU MLP, sandwich (pre+post) norms, sqrt(d)-scaled embeddings, vocab 256k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_q_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    mlp_variant="geglu",
    local_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sandwich_norm=True,
    scale_embedding=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
    attn_sharding="pad",
)
