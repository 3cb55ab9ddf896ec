"""The paper's own evaluation models (S5.1): OPT-30B/66B, Llama-30B, Llama2-70B.

The planner's profiles of the paper's evaluation and the orchestrated path's
models, all served: llama-30b and llama2-70b (GQA, RoPE, no biases, untied
embeddings) and opt-30b and opt-66b (MHA, sincos positions, biased
projections and GELU MLP, tied embeddings).
"""
from repro_torch.models.config import ModelConfig

CONFIGS = {
    "opt-30b": ModelConfig(
        name="opt-30b", family="dense", n_layers=48, d_model=7168,
        n_q_heads=56, n_kv_heads=56, head_dim=128, d_ff=28672,
        vocab_size=50_272, mlp_variant="gelu", qkv_bias=True, mlp_bias=True,
        pos_embedding="sincos", tie_embeddings=True),
    "opt-66b": ModelConfig(
        name="opt-66b", family="dense", n_layers=64, d_model=9216,
        n_q_heads=72, n_kv_heads=72, head_dim=128, d_ff=36864,
        vocab_size=50_272, mlp_variant="gelu", qkv_bias=True, mlp_bias=True,
        pos_embedding="sincos", tie_embeddings=True),
    "llama-30b": ModelConfig(
        name="llama-30b", family="dense", n_layers=60, d_model=6656,
        n_q_heads=52, n_kv_heads=52, head_dim=128, d_ff=17920,
        vocab_size=32_000, tie_embeddings=False),
    "llama2-70b": ModelConfig(
        name="llama2-70b", family="dense", n_layers=80, d_model=8192,
        n_q_heads=64, n_kv_heads=8, head_dim=128, d_ff=28672,
        vocab_size=32_000, tie_embeddings=False),
}
