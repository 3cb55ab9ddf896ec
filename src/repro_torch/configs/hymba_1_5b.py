"""Hymba-1.5B [arXiv:2411.13676]: 32L, d=1600, parallel attn + mamba heads.

25H GQA kv=5 (head_dim 64) in parallel with SSM heads (d_state=16); the two
path outputs are normalized and averaged.  The paper's meta-tokens are not
modelled.  Hybrid -> assigned long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_q_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    hybrid=True,
    ssm_state=16,
    ssm_heads=25,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
    tie_embeddings=True,
    max_seq_len=524_288,
    attn_sharding="replicate",  # 25 heads: pad would be 25->32 (28%) but KV=5
)
