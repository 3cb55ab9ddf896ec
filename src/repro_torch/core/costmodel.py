"""Appendix-E "one-time profiling" as an analytical model (the port's copy).

The paper profiles (i) per-layer prefill latency, (ii) per-layer decode latency,
and (iii) pipeline communication latency per (TP degree x workload type), then
composes them into per-replica capacities ``n_{k,j}`` (max type-j requests per
time span) and edge capacities ``e_{k,j}``.

The measurement step is replaced by a roofline cost model over the same
quantities (the profiling *interface* is pluggable: ``CostModel.measure_*``
can be overridden by a table of real measurements).  The model follows
Vidur-style decomposition, which the paper itself cites as the basis of its
profiler:

  prefill: compute-bound   t = FLOPs / (chips * peak * eff) + TP collectives + PP sends
  decode : HBM-bound       t = bytes(weights + KV) / (chips * bw * eff) + collectives

Capacities additionally respect the replica's KV/state memory budget.  The
hardware defaults to ``H100_SPEC``; the arithmetic is the JAX package's,
term for term, so both packages price a deployment identically.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

from repro_torch.core.types import (H100_SPEC, HardwareSpec, ReplicaConfig,
                                   WorkloadType)

BF16 = 2  # bytes


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """The minimal architecture description the cost model needs.

    Derived from a full ``repro_torch.models.config.ModelConfig`` via
    ``ModelConfig.profile()``; kept separate so the scheduler layer has no
    dependency on the model zoo.
    """

    name: str
    n_layers: int
    d_model: int
    n_q_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # MoE (0 experts == dense)
    n_experts: int = 0
    top_k: int = 0
    # SSM / hybrid
    ssm_state: int = 0            # d_state per head (0 == no SSM path)
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    hybrid_attn: bool = True      # hybrid archs keep an attention path too
    attn_free: bool = False       # pure SSM (mamba2): no KV cache at all
    param_bytes_per: float = BF16

    # ---------------- parameter counts ----------------

    @property
    def q_dim(self) -> int:
        return self.n_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def attn_params_per_layer(self) -> int:
        if self.attn_free:
            return 0
        d = self.d_model
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    @property
    def mlp_params_per_layer(self) -> int:
        if self.n_experts > 0:
            router = self.d_model * self.n_experts
            return router + self.n_experts * 3 * self.d_model * self.d_ff
        if self.d_ff == 0:
            return 0
        return 3 * self.d_model * self.d_ff  # SwiGLU: gate, up, down

    @property
    def mlp_active_params_per_layer(self) -> int:
        if self.n_experts > 0:
            router = self.d_model * self.n_experts
            return router + self.top_k * 3 * self.d_model * self.d_ff
        return self.mlp_params_per_layer

    @property
    def ssm_params_per_layer(self) -> int:
        if self.ssm_state == 0:
            return 0
        d_inner = self.ssm_heads * self.ssm_head_dim
        # in_proj (x, z, B, C, dt) + out_proj + conv
        n_bc = 2 * self.ssm_state
        return (self.d_model * (2 * d_inner + n_bc + self.ssm_heads)
                + d_inner * self.d_model + 4 * (d_inner + n_bc))

    @property
    def params_per_layer(self) -> int:
        return (self.attn_params_per_layer + self.mlp_params_per_layer
                + self.ssm_params_per_layer + 2 * self.d_model)

    @property
    def active_params_per_layer(self) -> int:
        return (self.attn_params_per_layer + self.mlp_active_params_per_layer
                + self.ssm_params_per_layer + 2 * self.d_model)

    @property
    def param_count(self) -> int:
        return self.n_layers * self.params_per_layer + 2 * self.vocab * self.d_model

    @property
    def active_param_count(self) -> int:
        return self.n_layers * self.active_params_per_layer + 2 * self.vocab * self.d_model

    @property
    def param_bytes(self) -> float:
        return self.param_count * self.param_bytes_per

    # ---------------- per-token memory ----------------

    @property
    def kv_bytes_per_token(self) -> float:
        if self.attn_free:
            return 0.0
        return 2 * self.kv_dim * self.n_layers * BF16

    @property
    def state_bytes_per_seq(self) -> float:
        if self.ssm_state == 0:
            return 0.0
        per_layer = self.ssm_heads * self.ssm_head_dim * self.ssm_state * 4  # fp32 state
        return per_layer * self.n_layers

    def seq_mem_bytes(self, total_len: int) -> float:
        """Resident bytes for one sequence at context length ``total_len``."""
        return self.kv_bytes_per_token * total_len + self.state_bytes_per_seq

    # ---------------- FLOPs ----------------

    def matmul_flops_per_token(self) -> float:
        """Dense matmul FLOPs per token (excludes attention score FLOPs)."""
        per_layer = 2 * (self.attn_params_per_layer
                         + self.mlp_active_params_per_layer
                         + self.ssm_params_per_layer)
        return self.n_layers * per_layer + 2 * self.vocab * self.d_model

    def attn_score_flops(self, new_tokens: int, ctx: int) -> float:
        """QK^T + AV FLOPs for `new_tokens` queries attending to <=ctx keys."""
        if self.attn_free:
            return 0.0
        avg_keys = (ctx + max(ctx - new_tokens, 0)) / 2  # causal average
        return self.n_layers * 4 * new_tokens * avg_keys * self.q_dim

    def ssm_scan_flops(self, new_tokens: int) -> float:
        if self.ssm_state == 0:
            return 0.0
        d_inner = self.ssm_heads * self.ssm_head_dim
        return self.n_layers * 6 * new_tokens * d_inner * self.ssm_state

    def prefill_flops(self, in_len: int) -> float:
        return (in_len * self.matmul_flops_per_token()
                + self.attn_score_flops(in_len, in_len)
                + self.ssm_scan_flops(in_len))

    def decode_flops_per_token(self, ctx: int) -> float:
        return (self.matmul_flops_per_token()
                + self.attn_score_flops(1, ctx)
                + self.ssm_scan_flops(1))


@dataclasses.dataclass(frozen=True)
class ReplicaPerf:
    """Measured/estimated serving characteristics for one (replica, workload)."""

    prefill_time: float          # s, one request's prefill on the replica
    decode_step_time: float      # s, one batched decode step at b_eff
    b_eff: int                   # effective decode batch size
    throughput: float            # requests/s for this type if served alone
    fits: bool


class CostModel:
    """One-time profiling result for one model on one hardware spec."""

    def __init__(self, profile: ModelProfile, hw: HardwareSpec | None = None,
                 span_seconds: float = 60.0, max_batch: int = 256,
                 prefill_chunk: int = 512, step_overhead: float = 3e-3,
                 collective_alpha: float = 15e-6):
        self.p = profile
        self.hw = hw or H100_SPEC
        self.span_seconds = span_seconds
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        # fixed costs that create the paper's DP-vs-TP trade-off (Fig. 1):
        # per-step scheduler/sampling/launch overhead (amortized over the
        # batch -> favors consolidation for memory-bound workloads) and a
        # per-collective latency floor (hurts large TP at small batch ->
        # favors DP for compute-bound short workloads).
        self.step_overhead = step_overhead
        self.collective_alpha = collective_alpha

    # -- building blocks (the quantities Appendix E profiles) ---------------

    def tp_collective_time(self, tokens: int, tp: int) -> float:
        """Two ring all-reduces of [tokens, d_model] bf16 per layer
        (bandwidth term + per-collective latency floor)."""
        if tp == 1:
            return 0.0
        bytes_ = tokens * self.p.d_model * BF16
        ring = 2.0 * (tp - 1) / tp * bytes_ / self.hw.ici_bw
        return 2 * self.p.n_layers * (ring + self.collective_alpha)

    def pp_send_time(self, tokens: int, pp: int) -> float:
        """(pp-1) boundary activations of [tokens, d_model] bf16."""
        if pp == 1:
            return 0.0
        return (pp - 1) * tokens * self.p.d_model * BF16 / self.hw.ici_bw

    def measure_prefill(self, cfg: ReplicaConfig, in_len: int) -> float:
        """End-to-end prefill latency of one request (compute-bound phase)."""
        flops = self.p.prefill_flops(in_len)
        compute = flops / (cfg.chips * self.hw.peak_flops * self.hw.mxu_flops_efficiency)
        return compute + self.tp_collective_time(in_len, cfg.tp) + \
            self.pp_send_time(in_len, cfg.pp)

    def measure_decode_step(self, cfg: ReplicaConfig, batch: int, ctx: int) -> float:
        """One decode step (all pp stages) for `batch` sequences at context ctx."""
        p, hw = self.p, self.hw
        weight_bytes = p.active_param_count * p.param_bytes_per
        kv_bytes = batch * p.seq_mem_bytes(ctx)
        mem_t = (weight_bytes + kv_bytes) / (cfg.chips * hw.hbm_bw * hw.hbm_efficiency)
        flops = batch * p.decode_flops_per_token(ctx)
        comp_t = flops / (cfg.chips * hw.peak_flops * hw.mxu_flops_efficiency)
        return (max(mem_t, comp_t) + self.step_overhead
                + self.tp_collective_time(batch, cfg.tp)
                + self.pp_send_time(batch, cfg.pp))

    # -- composition ---------------------------------------------------------

    def kv_budget_bytes(self, cfg: ReplicaConfig) -> float:
        """HBM left for KV/state across the whole replica (10% runtime reserve)."""
        total_hbm = cfg.chips * self.hw.hbm_bytes
        return 0.9 * total_hbm - self.p.param_bytes

    def fits(self, cfg: ReplicaConfig) -> bool:
        return self.kv_budget_bytes(cfg) > 0

    def max_concurrency(self, cfg: ReplicaConfig, w: WorkloadType) -> int:
        budget = self.kv_budget_bytes(cfg)
        if budget <= 0:
            return 0
        per_seq = max(self.p.seq_mem_bytes(w.total_len), 1.0)
        return max(0, min(self.max_batch, int(budget / per_seq)))

    def kv_hop_seconds(self, w: WorkloadType) -> float:
        """The prefill→decode handoff hop of a disaggregated pair: the
        prompt's KV pages cross the interconnect once.  (With a shared
        pool the runtime moves zero bytes — this prices the general
        cross-pool case, and acts as a mild tax that keeps the planner
        from disaggregating when the phases don't warrant it.)"""
        return self.p.kv_bytes_per_token * w.in_len / self.hw.ici_bw

    @lru_cache(maxsize=100_000)
    def replica_perf(self, cfg: ReplicaConfig, w: WorkloadType) -> ReplicaPerf:
        b_eff = self.max_concurrency(cfg, w)
        if b_eff == 0:
            return ReplicaPerf(math.inf, math.inf, 0, 0.0, False)
        avg_ctx = w.in_len + w.out_len // 2
        # Prefix-cache discount: a type whose prompts hit the cache for a
        # fraction of their tokens only prefills the uncached suffix (the
        # cached pages attach by refcount — zero compute).  The KV memory
        # term stays at full total_len: shared pages still occupy HBM.
        prefill_in = max(1, int(round(w.in_len * (1.0 - w.cached_frac))))
        prefill_t = self.measure_prefill(cfg, prefill_in)
        decode_t = self.measure_decode_step(cfg, b_eff, avg_ctx)
        # Pipeline bubble: decode across pp stages overlaps across microbatches;
        # with m in-flight microbatch groups, efficiency = m / (m + pp - 1).
        m = 4
        pp_eff = m / (m + cfg.pp - 1)
        # Disaggregated roles price their single phase: a prefill replica's
        # request costs one prefill forward plus the KV handoff hop (its
        # slot frees at first token); a decode replica's costs only the
        # decode stream.  (``cfg`` is frozen and hashable, so the role is
        # part of the lru_cache key automatically.)
        if cfg.role == "prefill":
            time_per_req = prefill_t + self.kv_hop_seconds(w)
            return ReplicaPerf(prefill_t, 0.0, b_eff,
                               1.0 / time_per_req, True)
        if cfg.role == "decode":
            time_per_req = w.out_len * decode_t / (b_eff * pp_eff)
            return ReplicaPerf(0.0, decode_t, b_eff,
                               1.0 / time_per_req, True)
        # Continuous batching: a request occupies one decode slot for out_len
        # steps, plus its prefill is chunked into the decode stream
        # (Sarathi-style), costing prefill_t of replica time.
        time_per_req = prefill_t + w.out_len * decode_t / (b_eff * pp_eff)
        thr = 1.0 / time_per_req
        return ReplicaPerf(prefill_t, decode_t, b_eff, thr, True)

    def capacity(self, cfg: ReplicaConfig, w: WorkloadType) -> float:
        """n_{k,j}: max type-j requests per time span if replica serves only j."""
        return self.replica_perf(cfg, w).throughput * self.span_seconds

    def edge_capacity(self, cfg: ReplicaConfig, w: WorkloadType) -> float:
        """e_{k,j}: per-type cap on requests routed to k in one span.

        Bounded by the pure-type capacity; memory concurrency is already folded
        into the throughput estimate.
        """
        return self.capacity(cfg, w)

    # -- reload / switching costs (used by the switch planner) ---------------

    def reload_seconds(self) -> float:
        """Naive model reload from host storage (the paper: minutes~50s)."""
        return self.p.param_bytes / self.hw.host_load_bw

    def min_chips(self) -> int:
        """Smallest chip count whose HBM fits params + reserve (paper: 140GB/70B)."""
        need = self.p.param_bytes / (0.9 * self.hw.hbm_bytes)
        return max(1, math.ceil(need))


def profile_capacities(
    cm: CostModel,
    replicas: list[ReplicaConfig],
    workloads: list[WorkloadType],
) -> tuple[list[list[float]], list[list[float]]]:
    """(n[k][j], e[k][j]) for the flow network.

    Disaggregated roles couple here: the flow network routes *admissions*,
    and in a disaggregated pair only the prefill replica admits — the
    decode replica receives contexts by handoff, outside the flow.  So a
    ``decode`` replica contributes zero admission capacity, and each
    ``prefill`` replica's capacity for type j is clipped by the decode
    side's ability to absorb its first-token-ready contexts:
    ``min(1, decode_cap_j / prefill_cap_j)`` — admitting prompts faster
    than the decode pool drains them just moves the queue downstream.
    ``mixed`` replicas are untouched.
    """
    n = [[cm.capacity(r, w) for w in workloads] for r in replicas]
    e = [[cm.edge_capacity(r, w) for w in workloads] for r in replicas]
    pre = [k for k, r in enumerate(replicas) if r.role == "prefill"]
    dec = [k for k, r in enumerate(replicas) if r.role == "decode"]
    if pre or dec:
        for j in range(len(workloads)):
            p_j = sum(n[k][j] for k in pre)
            d_j = sum(n[k][j] for k in dec)
            scale = min(1.0, d_j / p_j) if p_j > 0 else 0.0
            for k in pre:
                n[k][j] *= scale
                e[k][j] *= scale
        for k in dec:
            for j in range(len(workloads)):
                n[k][j] = e[k][j] = 0.0
    return n, e
