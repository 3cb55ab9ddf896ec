"""Chameleon-34B [arXiv:2405.09818]: early-fusion VLM backbone.

48L, d=8192, 64H GQA kv=8, d_ff=22016, unified vocab 65536 (text + VQ image
tokens).  QK-norm (chameleon's training stabilizer).  The VQ image tokenizer
is a stub: the model takes already-tokenized ids in the shared vocab.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_q_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65_536,
    qk_norm=True,
    rope_theta=10_000.0,
    tie_embeddings=False,
    modality="image_stub",
    attn_sharding="heads",
)
