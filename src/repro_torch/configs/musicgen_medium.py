"""MusicGen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens.

48L, d=1536, 24H MHA (kv=24), d_ff=6144 (non-gated GeLU), vocab 2048
(EnCodec codebook).  Absolute sinusoidal positions.  The EnCodec frontend +
codebook delay-pattern interleaving is a stub: the model takes precomputed
frame embeddings [B, S, d] (``embeds=``) or codebook ids; logits predict the
next codebook id.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_q_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    mlp_variant="gelu",
    mlp_bias=True,
    pos_embedding="sincos",
    tie_embeddings=False,
    modality="audio_stub",
    attn_sharding="pad",        # 24 -> 32 on TP=16
)
