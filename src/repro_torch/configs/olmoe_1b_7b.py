"""OLMoE-1B-7B [arXiv:2409.02060]: 16L, d=2048, 16H MHA, 64 experts top-8.

d_ff=1024 is the per-expert FFN width; ~1.3B active / ~6.9B total params.
OLMoE uses QK-norm and softmax-then-topk routing with normalized weights.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_q_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    qk_norm=True,
    rope_theta=10_000.0,
    tie_embeddings=False,
    expert_sharding="ep",       # 64 experts / 16-way model axis = 4 per shard
    # at 16L x d=2048 the sequence-parallel residual costs more in
    # collectives than it saves
    seq_parallel=False,
)
