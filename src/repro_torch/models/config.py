"""Model configuration for the PyTorch port.

The port's own copy of ``ModelConfig``: the same frozen dataclass, fields and
defaults as the JAX package's, so a config means the same model in both,
with the same cost-model bridge (``profile()``, ``param_count()``) into
the planner's ``ModelProfile``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.costmodel import ModelProfile


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_q_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention details
    pos_embedding: str = "rope"    # rope | sincos | none
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0    # gemma2
    final_logit_softcap: float = 0.0   # gemma2
    local_window: int = 0              # >0: alternate local/global (gemma2)
    sandwich_norm: bool = False        # gemma2 pre+post block norms
    scale_embedding: bool = False      # gemma2 sqrt(d) embedding scale
    norm_eps: float = 1e-6
    mlp_variant: str = "swiglu"        # swiglu | geglu | gelu (2-matmul)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    hybrid: bool = False               # parallel attn + SSM heads (hymba)

    # embeddings / io
    tie_embeddings: bool = True
    modality: str = "text"             # text | image_stub | audio_stub
    max_seq_len: int = 32_768

    # sharding preferences (kept so configs compare equal across packages)
    attn_sharding: str = "auto"        # auto | heads | pad | replicate
    expert_sharding: str = "auto"      # auto | ep | tp
    seq_parallel: bool = True
    scan_unroll: int = 1

    # ------------------------------------------------------------------

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def has_attn(self) -> bool:
        return not self.attn_free

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_dim(self) -> int:
        return self.n_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    def padded_vocab(self, multiple: int = 256) -> int:
        return _round_up(self.vocab_size, multiple)

    def local_is_local(self, layer: int) -> bool:
        """gemma2 alternation: even layers local, odd layers global."""
        return self.local_window > 0 and layer % 2 == 0

    # -- cost-model bridge ------------------------------------------------

    def profile(self) -> ModelProfile:
        return ModelProfile(
            name=self.name,
            n_layers=self.n_layers,
            d_model=self.d_model,
            n_q_heads=self.n_q_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            d_ff=self.d_ff,
            vocab=self.vocab_size,
            n_experts=self.n_experts,
            top_k=self.top_k,
            ssm_state=self.ssm_state,
            ssm_heads=self.ssm_heads,
            ssm_head_dim=self.ssm_head_dim,
            hybrid_attn=self.hybrid,
            attn_free=self.attn_free,
        )

    def param_count(self) -> int:
        return self.profile().param_count

    # -- smoke-scale reduction ---------------------------------------------

    def reduced(self, n_layers: int = 2, d_model: int = 64, n_q_heads: int = 4,
                n_kv_heads: int | None = None, d_ff: int = 128,
                vocab: int = 256, n_experts: int | None = None,
                top_k: int | None = None) -> "ModelConfig":
        """Same-family tiny config for CPU smoke tests."""
        kv = n_kv_heads if n_kv_heads is not None else max(1, n_q_heads // 2)
        kv = min(kv, n_q_heads)
        changes: dict = dict(
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_q_heads=n_q_heads,
            n_kv_heads=kv if self.n_kv_heads != self.n_q_heads else n_q_heads,
            head_dim=d_model // n_q_heads * 2,
            d_ff=0 if self.d_ff == 0 else d_ff,
            vocab_size=vocab,
            max_seq_len=512,
        )
        if self.is_moe:
            changes["n_experts"] = n_experts if n_experts is not None else 8
            changes["top_k"] = top_k if top_k is not None else 2
            changes["moe_capacity_factor"] = 2.0  # drop-free smoke tests
        if self.has_ssm:
            changes["ssm_state"] = 16
            changes["ssm_heads"] = 4
            changes["ssm_head_dim"] = 16
            changes["ssm_chunk"] = 64
        if self.local_window:
            changes["local_window"] = 64
        return dataclasses.replace(self, **changes)
