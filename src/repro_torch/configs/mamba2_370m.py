"""Mamba2-370M [arXiv:2405.21060]: 48L, d=1024, attention-free SSD.

d_inner = 2*d = 2048, head_dim 64 -> 32 SSM heads, d_state=128, 1 group.
Constant-size recurrent state -> assigned the long_500k decode shape.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_q_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                     # no MLP block (mamba2 mixer-only layers)
    vocab_size=50_280,
    ssm_state=128,
    ssm_heads=32,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
    tie_embeddings=True,
    max_seq_len=524_288,
)
