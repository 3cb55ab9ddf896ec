"""Ad hoc model switching (paper S4.2 + Appendix G, Algorithm 2).

A deployment switch changes the set of replicas and their (TP, PP) strategies.
Because every replica holds the same parameters, each *target* shard can be
fetched from any *source* device whose holdings overlap it, over fast
chip-to-chip links — instead of reloading the model from host storage.

Links: a *pod* is one fast-interconnect domain (``HardwareSpec.chips_per_pod``;
one NVLink box of 8 H100s), ``ici_bw`` its per-chip link rate and ``dcn_bw``
the per-host rate between pods (InfiniBand); the greedy planner prefers
intra-pod sources and balances per-pair communication load exactly as in
Algorithm 2.

Parameter geometry: a parameter element is identified by a point in the unit
square (layer fraction l, tensor-parallel fraction f).  A device of a replica
with strategy (tp, pp) at coordinates (stage s, rank r) holds the rectangle
[s/pp, (s+1)/pp) x [r/tp, (r+1)/tp).  Exact ``fractions.Fraction`` cuts keep
the grain decomposition lossless for any tp/pp mix (incl. TP=3, PP=2).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction

from repro_torch.core.costmodel import CostModel
from repro_torch.core.types import (H100_SPEC, ClusterSpec, Deployment,
                                   HardwareSpec, ReplicaConfig)


# --------------------------------------------------------------------------
# Placement: deployments -> concrete chip ids.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlacedReplica:
    config: ReplicaConfig
    chips: tuple[int, ...]  # length == config.chips; index = stage * tp + rank

    def holding(self, device_pos: int) -> tuple[Fraction, Fraction, Fraction, Fraction]:
        """Rectangle (l0, l1, f0, f1) held by the device at local position."""
        tp, pp = self.config.tp, self.config.pp
        stage, rank = divmod(device_pos, tp)
        return (Fraction(stage, pp), Fraction(stage + 1, pp),
                Fraction(rank, tp), Fraction(rank + 1, tp))


@dataclasses.dataclass(frozen=True)
class PlacedDeployment:
    replicas: tuple[PlacedReplica, ...]

    @property
    def all_chips(self) -> tuple[int, ...]:
        return tuple(c for r in self.replicas for c in r.chips)


def place_deployment(dep: Deployment, cluster: ClusterSpec,
                     chip_pool: list[int] | None = None) -> PlacedDeployment:
    """Assign chips contiguously (TP ranks adjacent -> same link neighborhood).

    Replicas are placed largest-first so big TP groups stay within one pod.
    """
    pool = list(range(cluster.chips)) if chip_pool is None else sorted(chip_pool)
    order = sorted(range(len(dep.replicas)),
                   key=lambda i: -dep.replicas[i].chips)
    placed: dict[int, PlacedReplica] = {}
    cursor = 0
    for i in order:
        cfg = dep.replicas[i]
        chips = tuple(pool[cursor:cursor + cfg.chips])
        if len(chips) < cfg.chips:
            raise ValueError("not enough chips in pool for deployment")
        cursor += cfg.chips
        placed[i] = PlacedReplica(cfg, chips)
    return PlacedDeployment(tuple(placed[i] for i in range(len(dep.replicas))))


# --------------------------------------------------------------------------
# Algorithm 2: greedy switch plan.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Transfer:
    src: int            # global chip id (or -1 for host reload)
    dst: int
    bytes: float
    intra_pod: bool
    grain: tuple        # (l0, l1, f0, f1) fractions, for audit


@dataclasses.dataclass
class SwitchPlan:
    transfers: list[Transfer]
    local_bytes: float          # satisfied from the device's own HBM (free)
    host_bytes: float           # no chip source existed -> host reload path
    total_param_bytes: float

    def moved_bytes(self) -> float:
        return sum(t.bytes for t in self.transfers)

    def estimate_seconds(self, hw: HardwareSpec) -> float:
        """Bottleneck-link estimate: per-chip intra-pod send/recv + per-host
        inter-pod traffic."""
        sent_ici: dict[int, float] = {}
        recv_ici: dict[int, float] = {}
        dcn_host: dict[int, float] = {}
        for t in self.transfers:
            if t.intra_pod:
                sent_ici[t.src] = sent_ici.get(t.src, 0.0) + t.bytes
                recv_ici[t.dst] = recv_ici.get(t.dst, 0.0) + t.bytes
            else:
                for host in (hw.host_of(t.src), hw.host_of(t.dst)):
                    dcn_host[host] = dcn_host.get(host, 0.0) + t.bytes
        t_ici = max(list(sent_ici.values()) + list(recv_ici.values()) + [0.0]) / hw.ici_bw
        t_dcn = max(list(dcn_host.values()) + [0.0]) / hw.dcn_bw
        t_host = self.host_bytes / hw.host_load_bw if self.host_bytes else 0.0
        return max(t_ici, t_dcn) + t_host


def _cuts(values: list[int]) -> list[Fraction]:
    pts = {Fraction(0), Fraction(1)}
    for v in values:
        for i in range(1, v):
            pts.add(Fraction(i, v))
    return sorted(pts)


def plan_switch(
    source: PlacedDeployment,
    target: PlacedDeployment,
    cm: CostModel,
    hw: HardwareSpec | None = None,
) -> SwitchPlan:
    """Algorithm 2 with the intra-machine(-pod)-first heuristic."""
    hw = hw or H100_SPEC
    param_bytes = cm.p.param_bytes

    # Source holdings: chip -> list of rectangles (a chip may appear once).
    src_holdings: list[tuple[int, tuple[Fraction, Fraction, Fraction, Fraction]]] = []
    for rep in source.replicas:
        for pos, chip in enumerate(rep.chips):
            src_holdings.append((chip, rep.holding(pos)))

    # Atomic grain grid from every tp/pp boundary in either deployment.
    l_cuts = _cuts([r.config.pp for r in source.replicas]
                   + [r.config.pp for r in target.replicas])
    f_cuts = _cuts([r.config.tp for r in source.replicas]
                   + [r.config.tp for r in target.replicas])

    def covers(rect, l0, l1, f0, f1) -> bool:
        return rect[0] <= l0 and rect[1] >= l1 and rect[2] <= f0 and rect[3] >= f1

    # Pre-index: grain -> source chips holding it.
    grain_sources: dict[tuple, list[int]] = {}
    grains: list[tuple] = []
    for li in range(len(l_cuts) - 1):
        for fi in range(len(f_cuts) - 1):
            g = (l_cuts[li], l_cuts[li + 1], f_cuts[fi], f_cuts[fi + 1])
            holders = [chip for chip, rect in src_holdings
                       if covers(rect, *g)]
            grains.append(g)
            grain_sources[g] = holders

    pair_load: dict[tuple[int, int], float] = {}
    src_total: dict[int, float] = {}
    transfers: list[Transfer] = []
    local_bytes = 0.0
    host_bytes = 0.0

    for rep in target.replicas:
        for pos, chip in enumerate(rep.chips):
            need = rep.holding(pos)
            for g in grains:
                if not covers(need, *g):
                    continue
                vol = float((g[1] - g[0]) * (g[3] - g[2])) * param_bytes
                holders = grain_sources[g]
                if chip in holders:
                    local_bytes += vol        # already resident -> free
                    continue
                if not holders:
                    host_bytes += vol         # cold start: host reload path
                    continue
                intra = [s for s in holders if hw.pod_of(s) == hw.pod_of(chip)]
                pool = intra if intra else holders
                # Greedy: min per-pair load, tie-break min per-source total
                # (pseudocode uses C_{s->t}; the text's "least data sent so
                # far" is the tie-break).
                s_star = min(pool, key=lambda s: (pair_load.get((s, chip), 0.0),
                                                  src_total.get(s, 0.0), s))
                pair_load[(s_star, chip)] = pair_load.get((s_star, chip), 0.0) + vol
                src_total[s_star] = src_total.get(s_star, 0.0) + vol
                transfers.append(Transfer(s_star, chip, vol, bool(intra), g))
    return SwitchPlan(transfers, local_bytes, host_bytes, param_bytes)


# --------------------------------------------------------------------------
# KV-cache migration (paper S4.2 "KV cache transmission").
# --------------------------------------------------------------------------


@dataclasses.dataclass
class KVMigrationPlan:
    drained: list[int]          # request ids left to finish on the source
    migrated: list[tuple[int, float]]  # (request id, bytes moved)
    handoff: list[int] = dataclasses.field(default_factory=list)
    # destination-side pre-allocated KV buffers: page-rounded moved bytes
    # inflated by the fragmentation headroom (paper: fixed-size buffers)
    reserved_bytes: float = 0.0

    def moved_bytes(self) -> float:
        return sum(b for _, b in self.migrated)

    def estimate_seconds(self, hw: HardwareSpec, intra_pod: bool = True) -> float:
        """Transfer stall: moved bytes over the fast (intra-pod) or slow
        (inter-pod) link.  Page handoffs are accounting-only — free."""
        bw = hw.ici_bw if intra_pod else hw.dcn_bw
        return self.moved_bytes() / bw if self.moved_bytes() else 0.0


def plan_kv_migration(
    cm: CostModel,
    request_lens: dict[int, int],
    drain_threshold: int = 2048,
    headroom: float = 0.15,
    *,
    shared_pool: bool = False,
    page_tokens: int = 16,
) -> KVMigrationPlan:
    """Short-sequence requests drain on the source; long ones migrate.

    ``shared_pool=True`` models the runtime's page-handoff path (source and
    destination replicas are views of one device ``BlockPool``): migrated
    sequences transfer by ownership re-registration, moving zero bytes.
    Otherwise bytes move page-granular — a sequence of context ``ctx``
    occupies ``ceil(ctx / page_tokens)`` full pages, and the whole page
    transfers, not just its live tokens.

    ``headroom`` reproduces the paper's pre-allocated fixed-size KV buffers
    (+10-20% for fragmentation) — it inflates the destination's reserved
    bytes, not the moved bytes.
    """
    drained: list[int] = []
    migrated: list[tuple[int, float]] = []
    handoff: list[int] = []
    reserved = 0.0
    for rid, ctx in request_lens.items():
        if ctx < drain_threshold:
            drained.append(rid)
            continue
        pages = -(-ctx // page_tokens)
        bytes_ = cm.p.seq_mem_bytes(pages * page_tokens)
        reserved += bytes_ * (1.0 + headroom)
        if shared_pool:
            handoff.append(rid)
        else:
            migrated.append((rid, bytes_))
    return KVMigrationPlan(drained, migrated, handoff, reserved)
