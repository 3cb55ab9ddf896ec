"""Top-k mixture-of-experts with group-local capacity dispatch.

The port of the JAX package's ``models/moe.py``, in plain tensor functions
on the tensors' own device (no kernel of its own: the reference is plain
``jnp`` too, so the products run on the library's matmuls).

  * routing is an fp32 router, softmax, then top-k (descending, as
    ``lax.top_k`` orders it) with the gates renormalised and their sum
    clipped at 1e-9 (OLMoE-style);
  * up to ``DENSE_TOKENS`` tokens (decode steps, CPU-scale and serving
    prefill), ``moe_dense`` runs every expert on every token and combines
    them with the gates: exact, no drops;
  * above that, ``moe_block`` dispatches by capacity: tokens are grouped
    along the batch (``_pick_groups``), each (group, expert) has
    ``C = ceil(K * N * cf / E)`` slots, a token's slot is the one-hot
    *exclusive* cumulative count of earlier (token, slot) assignments to
    its expert in the flattened token-major order, and assignments past
    ``C`` go to the dump slot ``E * C`` and are dropped, as the JAX
    package drops them, to the row.

Expert weights are [E, d, ff] (``w_gate``, ``w_up``) and [E, ff, d]
(``w_down``), SwiGLU; the router [d, E] stays fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

# moe_block's dense path takes at most this many tokens (B * S)
DENSE_TOKENS = 2048


def init_moe(cfg: ModelConfig, normal) -> dict:
    """Layer-stacked MoE weights with the JAX package's keys, shapes and
    scales; ``normal(shape, std, dtype=None)`` draws them (one expert slab
    at a time), the router in fp32 whatever dtype the rest take."""
    L, d, ff, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    return {
        "router": normal((L, d, E), s_in, torch.float32),
        "w_gate": normal((L, E, d, ff), s_in),
        "w_up": normal((L, E, d, ff), s_in),
        "w_down": normal((L, E, ff, d), s_out),
    }


def _pick_groups(n_tokens_per_seq: int, batch: int, n_experts: int,
                 top_k: int) -> int:
    """Groups divide the batch; keep tokens/group >= ~4*E/topk so the
    per-expert capacity ceil() stays cheap, but cap group size for memory."""
    target_tokens = max(4 * n_experts // max(top_k, 1), 64)
    g = batch
    while g > 1 and (batch // g) * n_tokens_per_seq < target_tokens:
        # halve groups (g must divide batch; walk divisors downward)
        for cand in range(g - 1, 0, -1):
            if batch % cand == 0:
                g = cand
                break
        else:
            g = 1
    return max(1, g)


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """x [..., d] -> (probs [..., E] fp32, renormalised gates [..., K] fp32,
    expert ids [..., K] int64, descending).  The router is taken in fp32
    (the trainer's bf16 compute copy is promoted back, as JAX promotes)."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gate_vals, topi = torch.topk(probs, top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, topi


def dense_gates(xt: torch.Tensor, router: torch.Tensor, top_k: int
                ) -> torch.Tensor:
    """The routing of tokens xt [N, d] as dense gates [N, E] fp32: each
    token's renormalised top-k gates at its experts, zeros elsewhere."""
    probs, gate_vals, topi = _route(xt, router, top_k)
    return torch.zeros_like(probs).scatter_(-1, topi, gate_vals)


def dense_experts(xt: torch.Tensor, p: dict, gates: torch.Tensor
                  ) -> torch.Tensor:
    """Every expert of ``p`` on every token xt [N, d], combined with
    ``gates`` [N, E_p] in xt's dtype -> [N, d].  ``p`` may hold a slice of
    the experts (``gates`` then holds their columns) or a slice of every
    expert's ff axis: the sharded executor sums such partial outputs."""
    gate = torch.matmul(xt, p["w_gate"])               # [E, N, ff]
    up = torch.matmul(xt, p["w_up"])
    y_all = torch.matmul(F.silu(gate) * up, p["w_down"])   # [E, N, d]
    return torch.einsum("end,ne->nd", y_all, gates.to(xt.dtype))


def moe_dense(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Decode-path MoE: every expert's SwiGLU on every token, combined with
    the gates in x's dtype.  Exact (no capacity drops).  Batched over
    experts, so no weight is copied.  x [B, S, d] -> [B, S, d]."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    y = dense_experts(xt, p, dense_gates(xt, p["router"], cfg.top_k))
    return y.reshape(B, S, d)


def dispatch(x: torch.Tensor, p: dict, cfg: ModelConfig,
             capacity_factor: float | None = None):
    """The capacity path's routing of x [B, S, d]: (G, C, gate values
    [G, N, K] fp32, keep [G, N, K] bool, slot [G, N, K] in [0, E * C],
    E * C being the dump slot); ``~keep`` marks the dropped (token, slot)
    pairs."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G, C = capacity_groups(S, B, cfg, capacity_factor)
    N = (B // G) * S                      # tokens per group
    _, gate_vals, topi = _route(x.reshape(G, N, -1), p["router"], K)
    keep, slot = capacity_slots(topi, E, C)
    return G, C, gate_vals, keep, slot


def capacity_groups(S: int, B: int, cfg: ModelConfig,
                    capacity_factor: float | None = None
                    ) -> tuple[int, int]:
    """(G, C) of the capacity path for a batch of B sequences of S tokens:
    ``_pick_groups``'s group count and the slots per (group, expert)."""
    E, K = cfg.n_experts, cfg.top_k
    cf = (capacity_factor if capacity_factor is not None
          else cfg.moe_capacity_factor)
    G = _pick_groups(S, B, E, K)
    return G, max(1, int(math.ceil(K * (B // G) * S * cf / E)))


def capacity_slots(topi: torch.Tensor, E: int, C: int):
    """(keep, slot) [G, N, K] of expert ids ``topi`` [G, N, K]: a (token,
    slot) pair's position in its expert's buffer is the count of earlier
    assignments to the same expert in the group, token-major; pairs past
    ``C`` are dropped to the dump slot ``E * C``."""
    G, N, K = topi.shape
    oh = F.one_hot(topi, E).reshape(G, N * K, E)
    pos = torch.cumsum(oh, dim=1) - oh                 # exclusive cumsum
    pos = (pos * oh).sum(-1).reshape(G, N, K)
    keep = pos < C
    slot = torch.where(keep, topi * C + pos, E * C)    # overflow -> dump
    return keep, slot


def capacity_experts(x: torch.Tensor, p: dict, routing, e0: int = 0
                     ) -> torch.Tensor:
    """The capacity path's experts and combine for x [B, S, d] routed by
    ``dispatch`` (``routing``).  ``p`` holds experts [e0, e0 + E_p) (every
    one, or an expert-parallel shard's) at their full ff width or a slice
    of it; (token, slot) pairs routed to other experts go to the dump
    slot, so a shard's output is its experts' part of the sum."""
    B, S, d = x.shape
    G, C, gate_vals, keep, slot = routing
    E = p["w_gate"].shape[0]
    K = slot.shape[-1]
    N = (B // G) * S
    # this p's experts own slots [e0 * C, (e0 + E) * C); the rest (other
    # shards' experts and the overflow) go to its dump slot.  With every
    # expert this leaves ``slot`` as it is.
    mine = keep & (slot >= e0 * C) & (slot < (e0 + E) * C)
    slot = torch.where(mine, slot - e0 * C, E * C)
    idx = slot.reshape(G, N * K, 1).expand(G, N * K, d)
    # scatter each (token, slot) into its expert's buffer; every kept slot
    # takes one token, the dump slot the overflow
    buf = torch.zeros((G, E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_add_(1, idx, x.reshape(G, N, d).repeat_interleave(K, dim=1))
    # the SwiGLU experts, batched over experts: [E, G * C, d]
    xe = buf[:, :E * C].reshape(G, E, C, d).transpose(0, 1).reshape(
        E, G * C, d)
    h = F.silu(torch.matmul(xe, p["w_gate"])) * torch.matmul(xe, p["w_up"])
    out = torch.matmul(h, p["w_down"]).reshape(E, G, C, d).transpose(0, 1)
    out = torch.cat([out.reshape(G, E * C, d),
                     torch.zeros((G, 1, d), dtype=out.dtype,
                                 device=out.device)], dim=1)
    # gather back and combine with the kept gates
    slots_out = torch.gather(out, 1, idx).reshape(G, N, K, d)
    w = (gate_vals * keep).to(x.dtype)[..., None]
    return (slots_out * w).sum(dim=2).reshape(B, S, d)


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
              capacity_factor: float | None = None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]: ``moe_dense`` up to DENSE_TOKENS tokens,
    capacity dispatch above (see the module docstring)."""
    B, S, d = x.shape
    if B * S <= DENSE_TOKENS:
        return moe_dense(x, p, cfg)
    return capacity_experts(x, p, dispatch(x, p, cfg, capacity_factor))


def load_balance_loss(x: torch.Tensor, p: dict, cfg: ModelConfig
                      ) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e / K, with f_e the
    fraction of tokens whose top-k set contains e and P_e the mean router
    probability."""
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(
        x.reshape(-1, x.shape[-1]).float() @ p["router"].float(), dim=-1)
    _, topi = torch.topk(probs, K, dim=-1, sorted=True)
    f = F.one_hot(topi, E).float().sum(1).mean(0)
    return E * torch.sum(f * probs.mean(0)) / K


def balance_sums(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``load_balance_loss``'s sums over the tokens of x [..., d]: the
    count of tokens whose top-k set holds each expert and the sum of each
    expert's router probability, [E] fp32 each.  A batch split over data
    shards sums these in shard order and divides by the whole batch's
    token count once (the product of two batch means)."""
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(
        x.reshape(-1, x.shape[-1]).float() @ router.float(), dim=-1)
    _, topi = torch.topk(probs, K, dim=-1, sorted=True)
    return F.one_hot(topi, E).float().sum(1).sum(0), probs.sum(0)


def moe_ref(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Oracle: dense per-token expert evaluation (no capacity drops) at any
    token count; equal to ``moe_block`` whenever nothing overflows
    capacity."""
    return moe_dense(x, p, cfg)
