"""ClusterRuntime: execute span plans on live serving engines, on one card.

The port of the JAX package's ``serving/cluster.py``.
``docs/architecture.md`` is the narrative guide — the request lifecycle
end to end, the migration ladder and who reuses it, and the failure
model; ``docs/telemetry.md`` explains how to read an exported trace.
This docstring keeps the runtime-policy reference detail.

A span plan's heterogeneous deployment (anything with
``.deployment.replicas`` and ``.fractions``: ``core.orchestrator``'s
``SpanPlan``, or a hand-built one) is materialized as N live
``ServingEngine`` replicas partitioning one shared device ``BlockPool`` on
one card.  A replica's chips are the runtime's own accounting: its chip
count scales its KV-block quota in the one pool, its concurrency
(``max_seqs``) and its per-sequence context ceiling, so a 1-chip replica
really is a smaller server than a 4-chip one, though every replica runs
on the same card.

Per span, typed requests are routed through any ``Router`` policy
(``FlowRouter`` realizes the plan's x[k][j] fractions), and every replica
is stepped round-robin on the host, *asynchronously*: each tick fires every
replica's decode dispatch (``engine.step_async``) before syncing any
tokens back (``engine.finish_step``), so the host never blocks on one
replica's device→host token transfer before dispatching the next.  The
replicas' kernels run on one card and one stream, so their device work is
serialized; what overlaps is the host's scheduling with the queued device
work.  With ``decode_horizon > 1`` each dispatch covers up to that many
decode steps (one transfer per horizon; see ``ServingEngine``).
``finish_span`` feeds two observations back to an attached orchestrator:

  * ``observe_health`` — per-replica achieved/expected throughput (tokens
    emitted per busy slot-tick), so a straggling replica's EWMA health
    shrinks its capacity in the next assignment and traffic routes around
    it;
  * ``observe_rates`` — realized per-type arrival counts, an EWMA the
    caller can blend with (or substitute for) the workload predictor.

At a span boundary, ``apply_plan`` executes the deployment switch for real:
replicas whose ``ReplicaConfig`` changed stop admitting, run a bounded
**drain** window so short sequences finish in place, **export** the rest
as snapshots that keep ownership of their live KV pages, and are rebuilt
under the new configuration; exported requests are re-routed through the
new assignment (batched per destination replica) and restored through the
migration subsystem (``repro_torch.serving.migration``): because every
replica is a view of the one shared ``BlockPool``, in-flight sequences
migrate by **page handoff** — pure ownership re-registration, zero tokens
recomputed, no data movement — with re-prefill as the costlier fallback.
Every path is token-for-token identical to an uninterrupted run under
greedy decoding.  Unchanged replicas keep serving throughout, and
``total_prefill_tokens`` exposes the cluster-wide prefill-forward token
count that the zero-recompute guarantee is asserted against.

``finish_span`` additionally reports the in-flight context lengths to
``observe_inflight`` so a planner can price the KV migration a
prospective switch would trigger.

``set_throttle`` injects a straggler (a replica that only steps a fraction
of the ticks) for chaos/regression testing of the health feedback loop.

With ``shard=True`` a replica's (tp, pp) is *executed*, not just modeled:
the runtime carves its chips into one contiguous sub-mesh per replica
(``launch.mesh.make_replica_mesh``), shards each replica's params and paged
KV pool per the serve ``ShardingPlan`` (heads/d_ff/vocab over tp, layers
over pp, KV pools along the KV-head axis; ``models.sharded`` runs them),
and deployment switches rebuild meshes.  Replicas then hold per-replica
pools, so switch-time migrations ride the cross-pool ``reshard_blocks``
path (dense gather, the hop, head-sharded scatter): bytes move, but still
zero tokens recomputed.  On one card the chips are virtual: ``devices``
defaults to the runtime's device repeated ``total_chips`` times, and each
chip keeps an id of its own, so slices, failures and repairs track chips
even where their devices are equal.  Co-located shards run the sharded
path, not tensor parallelism's speed.  Every family runs sharded; an SSM
model's requests move with their SSM rows, assembled from the source's
shards and split into the destination's.

Failure model
-------------
See the "Failure model" section of ``docs/architecture.md`` for the
narrative (detect / recover / shed, and why zero emitted tokens are
ever lost).  Implementation anchors: ``ReplicaCrash`` and sync-phase
injected faults kill a replica outright; transient dispatch errors and
admission ``MemoryError``s retry with exponential backoff and escalate
after ``max_retries``; stalls are caught by the health loop and the
rebalancer's watchdog.  Recovery rides the migration ladder, falling back
to re-prefill from the host-side **request log** (prompt + every emitted
token, updated at each sync) when device state is untrusted (``lose_pages``
crashes, or host/device length disagreement).  Unplaceable requests land
in ``shed_rids``; dead replicas' chips leave the planning budget via
``observe_failures``.  Only the ``serving.faults`` family and
``MemoryError`` are caught on the step path: a CUDA error (a failed
launch, ``torch.OutOfMemoryError``, which is a ``RuntimeError``) is a
fault of the program or the card, and propagates.

Disaggregated roles
-------------------
When a plan carries ``ReplicaConfig.role`` splits (``prefill`` /
``decode``; see ``docs/architecture.md`` for the why), the runtime:
routes new requests to ``prefill``/``mixed`` replicas and decode-phase
work to ``decode``/``mixed`` ones (``_route`` / ``_pick_dst`` /
``_resume_evicted`` all narrow by role but *relax* when no compatible
replica is live — roles are a preference, not a law); sizes decode
replicas for residency (bigger quota and ``max_seqs`` over the same
shared pool — reservations still bound true usage); and every tick
(``_handoff_post``) exports each prefill-role replica's
first-token-ready requests *keeping their pages* and adopts them on a
decode replica via the same-pool handoff — zero bytes, zero recompute.
Handoffs are counted per span (``SpanReport.handoffs`` /
``SpanReport.handoff``) and per engine (``handoff_in``/``handoff_out``
in ``load_stats``); prefill-replica health is measured as
progress-per-work-tick liveness, since token throughput would
under-measure a replica whose sequences leave at first token.

Rebalancing and preemption policy
---------------------------------
With ``rebalance=`` set (a ``RebalanceConfig``, or ``True`` for defaults)
the same migration ladder becomes a *continuously available* scheduling
action instead of a switch/crash-only mechanism (Llumnix-style live
rescheduling).  Every tick, under a per-tick move budget
(``max_moves_per_tick``), the runtime may:

  * **Straggler escape** — a step-loop watchdog counts consecutive ticks
    a replica had work but made no progress (a chaos ``stall``/``slow``,
    a real frozen replica).  At ``watchdog_ticks`` the replica is marked
    *degraded*: admission pauses, routing masks it out, and its requests
    drain onto survivors through the cheapest migration path — this runs
    in the async dispatch→sync *overlap window*, which is safe precisely
    because a zero-progress replica has no in-flight dispatch to race
    with.  Only after ``escalate_ticks`` of sustained degradation does
    the watchdog escalate to ``fail_replica`` — a hang becomes graceful
    degradation, not a ``ClusterHangError``.  A degraded replica that
    dispatches again is immediately un-degraded and resumes admitting.
  * **Hot-spot relief** — replicas whose queue depth reaches
    ``hot_queue`` or whose free-page fraction falls below
    ``hot_kv_frac`` shed load: queued never-prefilled requests move
    first (a free requeue), then the cheapest resident sequence
    (smallest context) rides a page handoff to the least-loaded live
    replica at or below ``cold_load``.
  * **Priority preemption** — when a high-priority request is queued on
    a replica that cannot admit it, the cost ladder is *relocation >
    eviction > shedding*: the cheapest lower-priority resident victim is
    first migrated to a survivor (zero recompute); failing that it is
    evicted — exported to the host request log, pages freed, resumed
    later by re-prefill on whichever replica has genuine room (zero
    emitted tokens lost); only when neither is possible does anything
    shed.  ``priority`` plumbs through ``submit`` on engine and cluster;
    admission itself is priority-ordered inside the engine.

The two control loops are kept from fighting: every span, ``finish_span``
reports the rebalancer's move count to ``observe_rebalance``, whose churn
EWMA raises a planner's switch-hysteresis bar.  The standing bar holds on
every rebalance path: greedy token parity with an unperturbed run, zero
emitted tokens lost, and zero recompute on handoff-path moves.

Switch transaction
------------------
``apply_plan`` is transactional (prepare → commit, with rollback).
PREPARE builds every new engine before any live engine is touched, so a
build failure aborts with zero impact.  Then the old replicas drain and
export their in-flight requests *keeping their KV pages*.  COMMIT
installs the new engines, re-routes, and restores the exported requests
per destination.  If a migration fails mid-commit, ROLLBACK re-exports
whatever already landed on new engines (another free page handoff),
rebuilds the old configuration, restores every request onto its origin
replica, and reverts the router and orchestrator state — the switch
reports ``rolled_back=True``, with the caught error's text in
``failure``, instead of raising, and serving continues on the old
deployment.  Both phases catch every exception, so a kernel failure
inside a switch also ends as a rollback: ``chip_smoke.py`` treats any
rollback on the card as a failure and prints ``failure``.

Telemetry
---------
Pass ``telemetry=`` (a ``serving.telemetry.Telemetry`` bundle) and the
whole stack instruments itself: every engine is built with the bundle and
its replica index as ``trace_id``, an attached orchestrator's ``audit``
attribute is pointed at the bundle's ``DecisionAudit`` (joined with the
realized ``SpanReport`` by ``finish_span``), and the cluster emits the
events engines cannot see: ``migrate`` / ``rebalance`` / ``handoff`` (per
request, with src/dst replica and restore path), ``crash`` /
``recovered`` (with the recovery stall), ``degraded``, ``preempt``,
terminal ``finish_log`` / ``shed`` for requests the cluster finishes or
drops outside any engine, and ``switch_prepare`` / ``switch_commit`` /
``switch_rollback`` begin/end pairs, plus the ``switch_stall_s`` /
``recovery_stall_s`` histograms.  The event schema lives in
``serving.telemetry``; the events and their fields are the JAX package's.

``load_stats()`` returns one dict per replica: the engine's FROZEN
``LOAD_STATS_KEYS`` schema plus the cluster-level ``dead`` flag (replica
masked out of routing / stepping until rebuilt).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import ReplicaConfig
from repro_torch.launch.mesh import make_replica_mesh
from repro_torch.launch.sharding import make_plan, pad_attention_params
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import (EngineRequest, InflightSnapshot,
                                        ServingEngine)
from repro_torch.serving.faults import (FaultError, FaultPlan, InjectedOOM,
                                        ReplicaCrash, TransientDispatchError,
                                        error_for)
from repro_torch.serving.kvcache import BlockPool
from repro_torch.serving.migration import (MigrationReport, migrate_batch,
                                           release_snapshot_pages)
from repro_torch.serving.router import FlowRouter, Router
from repro_torch.serving.telemetry import NULL_TELEMETRY


class ClusterHangError(RuntimeError):
    """``run_until_idle`` exhausted its tick budget with requests still
    pending — a hang (wedged replica, starved queue) must surface instead
    of masquerading as completion."""


@dataclasses.dataclass
class RebalanceConfig:
    """Knobs for the live rebalancer (see the module docstring's policy
    section).  Pass ``rebalance=True`` to ``ClusterRuntime`` for these
    defaults; ``None`` (the default) disables mid-span rebalancing
    entirely and preserves the pre-rebalancer behavior."""
    max_moves_per_tick: int = 2   # migration budget per cluster tick
    watchdog_ticks: int = 3       # zero-progress ticks before "degraded"
    escalate_ticks: int = 8       # degraded ticks before fail_replica
    hot_queue: int = 1            # queue depth that flags a hot spot
    hot_kv_frac: float = 0.125    # free-page fraction below which = hot
    cold_load: float = 0.75       # max load of a migration destination
    preempt: bool = True          # enable the priority-preemption ladder


@dataclasses.dataclass
class ReplicaHandle:
    """One live replica: its plan config, engine, and span counters."""
    index: int
    rc: ReplicaConfig
    engine: ServingEngine
    # health accounting (reset each span)
    slot_ticks: int = 0         # sum over ticks of busy slots (expected work)
    emitted_span: int = 0       # tokens actually emitted this span
    completed_span: int = 0     # requests this replica finished this span
    shed_mark: int = 0          # len(engine.shed_rids) at span start
    # straggler injection: step only every `period`-th tick
    period: int = 1
    # failure state: a dead handle stays in ``replicas`` (router indices
    # must remain stable mid-span) but is masked out of routing/stepping
    # until the next apply_plan rebuilds or drops it
    dead: bool = False
    failures: int = 0           # consecutive dispatch failures (retry budget)
    backoff_until: int = 0      # cluster tick the next retry may happen at
    # watchdog state (rebalancer only): consecutive had-work-no-dispatch
    # ticks, and whether/when the replica was marked degraded
    no_progress: int = 0
    degraded: bool = False
    degraded_tick: int = 0
    # liveness accounting (reset each span): ticks the replica had work,
    # and ticks it actually dispatched.  Token throughput under-measures a
    # prefill-role replica (its sequences leave at first token), so its
    # health is scored on progress/work instead of emitted/slot ticks.
    work_ticks: int = 0
    progress_ticks: int = 0


@dataclasses.dataclass
class SwitchReport:
    """What a deployment switch actually did to live requests."""
    changed: list[int]          # replica indices rebuilt
    drained: int                # requests that finished inside the drain window
    migrated: int               # in-flight requests resumed on a new replica
    requeued: int               # queued (never-admitted) requests re-routed
    # restore-path split of `migrated` (see serving.migration)
    handoff: int = 0            # same-pool page-ownership transfers (0 bytes)
    copied: int = 0             # cross-pool device page copies
    reprefilled: int = 0        # re-prefill fallback
    pages_handoff: int = 0
    pages_copied: int = 0
    recompute_tokens: int = 0   # context tokens the fallback re-prefilled
    dropped: int = 0            # exported requests no replica could hold
    # transactional outcome: when a rebuild/migration failed mid-switch the
    # old deployment was restored and the migration counters above describe
    # the *restore* trip back onto it (``failure`` says what went wrong)
    rolled_back: bool = False
    failure: str = ""

    @property
    def moved(self) -> int:
        return self.migrated + self.requeued


@dataclasses.dataclass
class SpanReport:
    """Observed span outcome (also what gets fed back to the orchestrator)."""
    achieved_fraction: list[float]   # per-replica achieved/expected throughput
    tokens: list[int]                # per-replica tokens emitted
    completed: int                   # requests finished this span
    type_counts: np.ndarray          # realized per-type arrivals [J]
    shed: int = 0                    # requests rejected by SLO (TTFT/TPOT)
    # failure accounting for the span
    dead_replicas: list[int] = dataclasses.field(default_factory=list)
    retries: int = 0                 # transient-failure retries (all replicas)
    recovery: MigrationReport = dataclasses.field(
        default_factory=MigrationReport)   # how dead replicas' requests moved
    # prefix-cache accounting (None / zeros when the cache is disabled)
    prefix_hit_rate: np.ndarray | None = None  # per-type token-weighted [J]
    prefix_hits: int = 0             # admissions that reused >= 1 page
    prefix_misses: int = 0           # admissions with no cached prefix
    prefix_evicted_bytes: int = 0    # device -> host tier, this span
    prefix_restored_bytes: int = 0   # host tier -> device, this span
    # live-rebalancer accounting for the span (zeros when disabled)
    rebalanced: int = 0              # sequences moved mid-span (all paths)
    preempted: int = 0               # lower-priority victims preempted
    rebalance: MigrationReport = dataclasses.field(
        default_factory=MigrationReport)   # path split of the moves
    # disaggregated prefill/decode accounting (zeros when every replica
    # is role "mixed"): first-token-ready contexts handed from prefill to
    # decode replicas, the migration-path split of those hops, and the
    # mean achieved fraction of the span's live replicas per role — the
    # decision audit's evidence for scoring the prefill:decode split
    handoffs: int = 0
    handoff: MigrationReport = dataclasses.field(
        default_factory=MigrationReport)
    role_util: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _RequestLog:
    """Host-side record of one request: prompt + every token the cluster
    has synced back for it.  This is the last-resort recovery source — a
    replica whose device state cannot be trusted (crash with pages lost,
    or a failure between dispatch and sync) rebuilds its requests from
    here by re-prefill, losing zero emitted tokens."""
    prompt: np.ndarray
    max_new_tokens: int
    emitted: list
    ttft_deadline: float | None = None
    tpot_deadline: float | None = None
    priority: int = 0


class ClusterRuntime:
    def __init__(self, cfg: ModelConfig, params, orch=None, *,
                 total_chips: int | None = None, blocks_per_chip: int = 32,
                 seqs_per_chip: int = 2, block_size: int = 16,
                 router: Router | None = None, drain_steps: int = 4,
                 decode_mode: str = "paged",
                 dtype=torch.float32, seed: int = 0,
                 prefill_chunk_tokens: int | None = None,
                 decode_horizon: int = 1,
                 prefix_cache: bool = False,
                 shard: bool = False, devices=None,
                 faults: FaultPlan | None = None, max_retries: int = 3,
                 telemetry=None,
                 rebalance: "RebalanceConfig | bool | None" = None,
                 device="cuda"):
        """Args:
          cfg/params: the (one) model every replica serves — heterogeneity
            is in per-replica capacity, not weights.
          orch: optional orchestrator (duck-typed: ``cluster.chips``,
            ``audit`` and the ``observe_*`` / ``on_switch_rollback``
            methods); when present, ``finish_span`` feeds it health +
            realized rates + in-flight context lengths (the
            migration-cost input for switch planning).
          total_chips: pool sizing when no orchestrator is attached.
          blocks_per_chip / seqs_per_chip: how a replica's chip count maps
            to its KV quota and concurrency.
          drain_steps: switch-time drain window (engine steps) before
            in-flight sequences are exported and migrated.
          prefill_chunk_tokens: chunked-prefill size for every replica
            (None = one-shot prefill; see ``ServingEngine``).
          decode_horizon: max fused decode steps per replica dispatch
            (1 = per-step decode; see ``ServingEngine``).
          prefix_cache: enable content-addressed prefix reuse + the host
            KV tier (``serving.prefixcache``).  With the default shared
            ``BlockPool`` every replica shares ONE index — a prefix
            prefilled anywhere warms the whole cluster and survives
            replica death.  Per-type hit rates flow back through
            ``finish_span`` into ``observe_prefix_hits``.
          shard: execute each replica's (tp, pp) for real — the chips
            (``devices``; ``devices=None`` means the runtime's ``device``
            repeated ``total_chips`` times, the counterpart of
            ``jax.devices()`` under a forced host device count) are carved
            into one contiguous sub-mesh per replica
            (``launch.mesh.make_replica_mesh``), params/KV pools are
            sharded per the serve ``ShardingPlan``, and deployment
            switches rebuild meshes.  Replicas then hold *per-replica*
            pools (a shared pool cannot span disjoint meshes), so in-flight
            migrations ride the cross-pool reshard path
            (``kvcache.reshard_blocks``) instead of the free same-pool page
            handoff — still zero recompute.  Paged decode only; every
            family.  ``devices`` is ignored without ``shard``.
          faults: optional ``serving.faults.FaultPlan`` consulted at each
            injection site (dispatch, admission, switch) — the
            deterministic chaos source; see the module docstring's
            failure-model section for what detection/recovery it drives.
          max_retries: consecutive transient dispatch failures a replica
            may accumulate (retried with exponential backoff) before it is
            declared dead and its requests are recovered onto survivors.
          telemetry: optional ``serving.telemetry.Telemetry`` bundle — see
            the module docstring's telemetry section.  The default is the
            disabled ``NULL_TELEMETRY`` (every emit point is a no-op).
          rebalance: enable the live rebalancer (``RebalanceConfig`` or
            ``True`` for defaults) — mid-span straggler drains, hot-spot
            relief, and priority preemption under a per-tick migration
            budget; see the module docstring's policy section.  ``None``
            (default) keeps migration a switch/crash-only mechanism.
          dtype / device: the KV pool's dtype, and where the pool and
            every engine live (``params`` must already be there); CUDA
            unless ``device="cpu"`` is passed.
        """
        if total_chips is None:
            if orch is None:
                raise ValueError("need total_chips when no orchestrator")
            total_chips = orch.cluster.chips
        self.cfg = cfg
        self.params = params
        self.orch = orch
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        if orch is not None and self.telemetry.enabled:
            # plan_span decisions audit into the same bundle finish_span
            # joins realized SpanReports into (calibration error)
            orch.audit = self.telemetry.audit
        self.total_chips = total_chips
        self.blocks_per_chip = blocks_per_chip
        self.seqs_per_chip = seqs_per_chip
        self.block_size = block_size
        self.drain_steps = drain_steps
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.decode_horizon = decode_horizon
        self.prefix_cache = prefix_cache
        self.decode_mode = decode_mode
        self.dtype = dtype
        self.seed = seed
        self.device = device
        self.shard = shard
        # chip ids: a replica's slice and a dead replica's stash are tuples
        # of ids into ``_chip_devices``, so chips on one device stay apart
        self._chip_devices: list = []
        self._chips: list[int] = []
        self._replica_devices: dict[int, tuple] = {}
        # (q_heads, kv_heads) -> head-padded params, reused across switches
        self._padded_params: dict[tuple, object] = {}
        if shard:
            if decode_mode != "paged":
                raise ValueError("shard=True needs decode_mode='paged'")
            self._chip_devices = [torch.device(d) for d in (
                devices if devices is not None else [device] * total_chips)]
            self._chips = list(range(len(self._chip_devices)))
            self.pool = None    # per-replica pools, one per sub-mesh
        else:
            self.pool = BlockPool(cfg, blocks_per_chip * total_chips,
                                  block_size, dtype, device)
        self.router: Router = router if router is not None else FlowRouter(
            [[1.0]])
        self.replicas: list[ReplicaHandle] = []
        self.results: dict[int, EngineRequest] = {}   # rid -> finished request
        self.rid_type: dict[int, int] = {}
        self.rid_owner: dict[int, int] = {}
        self.n_types = 1
        self._tick = 0
        self._span_completed = 0
        self._span_type_counts = np.zeros(1)
        # per-type prefix-cache accounting (token-weighted hit rates)
        self._span_hit_tokens = np.zeros(1)
        self._span_ctx_tokens = np.zeros(1)
        self._prefix_mark = (0, 0, 0, 0)      # hits/misses/evicted/restored
        self.switch_reports: list[SwitchReport] = []
        # prefill-forward tokens of replicas already torn down; together
        # with the live engines' counters this is `total_prefill_tokens`
        self._prefill_tokens_retired = 0
        # shed (TTFT-blown) rejections: rids of torn-down replicas are
        # folded in here at switch time, so a caller can always distinguish
        # a shed request from a still-queued one (it never reaches
        # ``results``)
        self.shed_rids: list[int] = []
        self._span_shed_mark = 0
        # fault tolerance
        self.faults = faults
        self.max_retries = max_retries
        self.request_log: dict[int, _RequestLog] = {}
        self.dead_replicas: list[int] = []    # cluster-lifetime death list
        # chip slices of dead sharded replicas, kept for repair_replica
        self._dead_devices: dict[int, tuple] = {}
        self.repaired_replicas: list[int] = []  # lifetime repair/rejoin list
        self.lost_chips = 0                   # chips on dead replicas
        self._span_dead: list[int] = []
        self._span_retries = 0
        self._span_recovery = MigrationReport()
        self._switch_count = 0                # apply_plan ordinal (1-based)
        self._switching = False               # mask injection inside switches
        # last successfully applied plan, for rollback restore
        self._applied_fractions: list | None = None
        # live rebalancer (None = disabled, the pre-rebalancer behavior)
        if rebalance is True:
            rebalance = RebalanceConfig()
        self.rebalance: RebalanceConfig | None = rebalance or None
        self._moves_left = 0                  # per-tick migration budget
        # preemption-evicted requests parked in the host log:
        # rid -> the replica index they were evicted from
        self._evicted: dict[int, int] = {}
        self._span_rebalanced = 0
        self._span_preempted = 0
        self._span_rebalance = MigrationReport()
        # disaggregated prefill→decode handoff accounting for the span
        self._span_handoffs = 0
        self._span_handoff = MigrationReport()

    # -- replica materialization ----------------------------------------------

    def _sizing(self, rc: ReplicaConfig) -> tuple[int, int, int]:
        """chips -> (max_seqs, kv_quota, max_blocks_per_seq)."""
        quota = self.blocks_per_chip * rc.chips
        max_seqs = max(1, self.seqs_per_chip * rc.chips)
        if rc.role == "decode":
            # the KV-residency side of a disaggregated pair: a decode
            # replica holds many concurrent contexts but never prefills,
            # so it carries a bigger quota view and much higher
            # concurrency.  With the shared pool this is safe
            # oversubscription — reservations check the pool's real free
            # blocks as well as the view quota.
            quota *= 2
            max_seqs *= 4
        cfg_cap = self.cfg.max_seq_len // self.block_size
        # a small replica also has a smaller per-sequence context ceiling:
        # one sequence may use at most its replica's whole block quota
        max_bps = max(1, min(cfg_cap, quota))
        return max_seqs, quota, max_bps

    @property
    def devices(self) -> list | None:
        """The live chips' devices (None unless ``shard``)."""
        if not self.shard:
            return None
        return [self._chip_devices[c] for c in self._chips]

    def _build_engine(self, rc: ReplicaConfig, chips=None,
                      index: int = 0) -> ServingEngine:
        max_seqs, quota, max_bps = self._sizing(rc)
        common = dict(
            block_size=self.block_size, max_seqs=max_seqs, dtype=self.dtype,
            greedy=True, seed=self.seed, decode_mode=self.decode_mode,
            max_blocks_per_seq=max_bps,
            prefill_chunk_tokens=self.prefill_chunk_tokens,
            decode_horizon=self.decode_horizon,
            prefix_cache=self.prefix_cache,
            telemetry=self.telemetry, trace_id=index, role=rc.role)
        if not self.shard:
            return ServingEngine(self.cfg, self.params, pool=self.pool,
                                 kv_quota=quota, device=self.device,
                                 **common)
        # real intra-replica parallelism: a sub-mesh of rc.chips chips, the
        # serve-mode sharding plan for (tp, pp), a private head-sharded
        # pool sized to this replica's quota
        mesh = make_replica_mesh([self._chip_devices[c] for c in chips],
                                 rc.tp, rc.pp, chips=chips)
        plan, run_cfg = make_plan(self.cfg, "serve", False, 1,
                                  tp=rc.tp, pp=rc.pp)
        params = self.params
        if (run_cfg.n_q_heads != self.cfg.n_q_heads
                or run_cfg.n_kv_heads != self.cfg.n_kv_heads):
            # head padding depends only on the padded head counts: cache it
            # so repeated switches don't re-pad the whole tree inside the
            # switch window
            key = (run_cfg.n_q_heads, run_cfg.n_kv_heads)
            params = self._padded_params.get(key)
            if params is None:
                params = pad_attention_params(self.params, self.cfg, run_cfg)
                self._padded_params[key] = params
        return ServingEngine(run_cfg, params, num_blocks=quota,
                             mesh=mesh, shard_plan=plan, **common)

    def _carve(self, rcs: list[ReplicaConfig]) -> list[tuple]:
        """Contiguous per-replica chip slices, in replica-index order."""
        need = sum(rc.chips for rc in rcs)
        if need > len(self._chips):
            raise ValueError(
                f"deployment needs {need} devices but this runtime has "
                f"{len(self._chips)} (pass devices= or shrink the plan)")
        slices, off = [], 0
        for rc in rcs:
            slices.append(tuple(self._chips[off:off + rc.chips]))
            off += rc.chips
        return slices

    def _make_handle(self, k: int, rc: ReplicaConfig,
                     engine: ServingEngine) -> ReplicaHandle:
        h = ReplicaHandle(k, rc, engine)
        self._wire_faults(h)
        return h

    def _wire_faults(self, h: ReplicaHandle) -> None:
        """Point the engine's admission-site fault hook at the plan (the
        dispatch/switch sites are consulted by the cluster directly)."""
        if self.faults is None:
            return

        def hook(site, h=h):
            if self._switching or h.dead:
                return
            spec = self.faults.admit_fault(self._tick, h.index)
            if spec is not None:
                raise InjectedOOM(
                    f"injected pool-reservation OOM on replica "
                    f"{h.index} (tick {self._tick})")

        h.engine.fault_hook = hook

    @property
    def surviving_chips(self) -> int:
        """Chips still in the planning budget (dead replicas' chips left)."""
        return self.total_chips - self.lost_chips

    @property
    def total_prefill_tokens(self) -> int:
        """Tokens that went through a prefill forward anywhere in the
        cluster's lifetime.  A switch whose migrations all ride the page-
        handoff path leaves this unchanged — asserted in tests."""
        return (self._prefill_tokens_retired
                + sum(h.engine.prefill_tokens for h in self.replicas))

    @property
    def all_shed_rids(self) -> list[int]:
        """Every rid rejected cluster-wide because its TTFT budget was
        already blown while still queued (SLO-aware shedding)."""
        return (self.shed_rids
                + [r for h in self.replicas for r in h.engine.shed_rids])

    @property
    def total_shed(self) -> int:
        return len(self.all_shed_rids)

    # -- span plan execution ----------------------------------------------------

    def apply_plan(self, plan) -> SwitchReport:
        """Materialize a span plan (``SpanPlan`` or anything with
        ``.deployment`` + ``.fractions``); executes the deployment switch on
        live engines when the configuration changed.

        Transactional (see the module docstring): new engines are built
        before any live engine is touched, and a failure mid-commit rolls
        the cluster back onto the old deployment — the returned report says
        ``rolled_back=True`` instead of the switch raising half-done."""
        new_rcs = list(plan.deployment.replicas)
        self.n_types = len(plan.fractions[0]) if plan.fractions else 1
        if len(self._span_type_counts) != self.n_types:
            self._span_type_counts = np.zeros(self.n_types)
            self._span_hit_tokens = np.zeros(self.n_types)
            self._span_ctx_tokens = np.zeros(self.n_types)
        old = self.replicas
        # sharded runtimes carve chips contiguously in replica order, so a
        # replica whose config is unchanged must ALSO keep its chip slice
        # to count as unchanged
        slices = self._carve(new_rcs) if self.shard else None
        old_devices = dict(self._replica_devices)
        # a dead replica always counts as changed: its engine is gone and
        # must be rebuilt (its requests were already recovered at death)
        changed = [k for k in range(len(new_rcs))
                   if k >= len(old) or old[k].rc != new_rcs[k]
                   or old[k].dead
                   or (self.shard
                       and self._replica_devices.get(k) != slices[k])]
        torn_down = [old[k] for k in changed
                     if k < len(old) and not old[k].dead]
        torn_down += [h for h in old[len(new_rcs):] if not h.dead]

        # 0) fail fast, before touching any engine: every request that may
        #    need migration must fit some replica of the new deployment
        #    (heterogeneous context ceilings), or the switch would strand it
        #    mid-way.  Conservative: requests that would finish in the drain
        #    window are counted too.
        ceilings = []
        for rc in new_rcs:
            _, quota, max_bps = self._sizing(rc)
            ceilings.append(min(max_bps, quota))
        stranded = []
        for h in torn_down:
            reqs = list(h.engine.active.values()) + list(h.engine.waiting)
            for r in reqs:
                ctx = len(r.prompt) + len(r.generated)
                remaining = r.max_new_tokens - len(r.generated)
                need = -(-(ctx + remaining - 1) // self.block_size)
                if all(need > c for c in ceilings):
                    stranded.append(r.rid)
        if stranded:
            raise ValueError(
                f"deployment switch would strand requests {stranded}: no "
                f"replica in the new deployment has a context ceiling large "
                f"enough to resume them; re-plan or drain first (no engine "
                f"state was modified)")

        self._switch_count += 1
        self._switching = True
        try:
            return self._apply_txn(plan, new_rcs, old, slices, old_devices,
                                   changed, torn_down)
        finally:
            self._switching = False

    def _apply_txn(self, plan, new_rcs, old, slices, old_devices, changed,
                   torn_down) -> SwitchReport:
        fault = (self.faults.switch_fault(self._switch_count)
                 if self.faults is not None else None)
        tm = self.telemetry
        reconfiguring = bool(changed) or bool(torn_down)
        t_switch = tm.clock() if (tm.enabled and reconfiguring) else None

        # PREPARE: build every new engine before a single live engine is
        # touched — a build failure aborts with the deployment unchanged
        built: dict[int, ServingEngine] = {}
        if tm.enabled and reconfiguring:
            tm.emit("switch_prepare", phase="begin",
                    span=self._switch_count)
        try:
            if fault is not None and fault.kind == "switch_build":
                raise TransientDispatchError(
                    f"injected engine-build failure "
                    f"(switch {self._switch_count})")
            for k in changed:
                built[k] = self._build_engine(
                    new_rcs[k], slices[k] if self.shard else None, index=k)
        except Exception as e:   # noqa: BLE001 — the abort must never wedge
            if tm.enabled and reconfiguring:
                tm.emit("switch_prepare", phase="end",
                        span=self._switch_count)
            report = SwitchReport([], 0, 0, 0, rolled_back=True,
                                  failure=f"prepare: {e}")
            self._revert_orchestrator()
            self.switch_reports.append(report)
            return report
        if tm.enabled and reconfiguring:
            tm.emit("switch_prepare", phase="end", span=self._switch_count)
            tm.emit("switch_commit", phase="begin", span=self._switch_count)

        # 1) drain window: short in-flight sequences finish on their source
        drained = 0
        migrate: list[InflightSnapshot] = []
        origin: dict[int, ReplicaHandle] = {}     # rid -> source handle
        for h in torn_down:
            h.engine.pause_admission()
            for r in h.engine.drain(self.drain_steps):
                self._record_finish(r, owner=h)
                drained += 1
            # 2) snapshot what's left *keeping the pages*: the sequences'
            #    KV stays resident in the shared pool across the rebuild
            snaps = h.engine.export_inflight(release=False)
            for s in snaps:
                self._log_tokens(s.rid, s.generated)
                origin[s.rid] = h
            migrate.extend(snaps)
            self._prefill_tokens_retired += h.engine.prefill_tokens
            self.shed_rids.extend(h.engine.shed_rids)
            h.engine.release_all()

        # COMMIT: 3) install the new handles and routing
        self.replicas = [
            old[k] if k not in changed and k < len(old)
            else self._make_handle(k, new_rcs[k], built[k])
            for k in range(len(new_rcs))
        ]
        self.router.reconfigure(plan.fractions)
        if self.shard:
            self._replica_devices = dict(enumerate(slices))

        # 4) re-route exported requests through the new assignment, batched
        #    per destination replica, and restore them via the migration
        #    subsystem: same-pool page handoff first (zero recompute), then
        #    device copy, then re-prefill.  Routing is capacity-masked: a
        #    snapshot only goes to a replica whose context ceiling can hold
        #    it (heterogeneous replicas differ here).
        mig = MigrationReport()
        src_idx = {rid: hh.index for rid, hh in origin.items()}
        try:
            by_dest, dropped = self._route_snapshots(migrate)
            mig.dropped += len(dropped)
            groups = sorted(by_dest.items())
            inject = fault is not None and fault.kind == "switch_migrate"
            for gi, (k, group) in enumerate(groups):
                if inject and gi == min(1, len(groups) - 1):
                    raise TransientDispatchError(
                        f"injected migration failure mid-switch "
                        f"(switch {self._switch_count})")
                rep_k = migrate_batch(self.replicas[k].engine, group)
                self._emit_migrations(rep_k, k, src_idx)
                mig.merge(rep_k)
            if inject and not groups:
                # the fault is scheduled by apply_plan ordinal: it must fire
                # even on a switch with nothing to migrate, or a seeded plan
                # would silently skip its rollback scenario
                raise TransientDispatchError(
                    f"injected migration failure mid-switch "
                    f"(switch {self._switch_count})")
        except Exception as e:   # noqa: BLE001 — roll back, never wedge
            if tm.enabled and reconfiguring:
                tm.emit("switch_commit", phase="end",
                        span=self._switch_count)
                tm.emit("switch_rollback", phase="begin",
                        span=self._switch_count)
            try:
                return self._rollback_switch(old, old_devices, torn_down,
                                             origin, migrate, drained, e)
            finally:
                if tm.enabled and reconfiguring:
                    tm.emit("switch_rollback", phase="end",
                            span=self._switch_count)
                    tm.metrics.observe("switch_stall_s",
                                       tm.clock() - t_switch)
        report = SwitchReport(
            changed, drained, mig.migrated, mig.requeued,
            handoff=mig.handoff, copied=mig.copied,
            reprefilled=mig.reprefilled, pages_handoff=mig.pages_handoff,
            pages_copied=mig.pages_copied,
            recompute_tokens=mig.recompute_tokens, dropped=mig.dropped)
        self.switch_reports.append(report)
        self._applied_fractions = [list(row) for row in plan.fractions]
        if tm.enabled and reconfiguring:
            tm.emit("switch_commit", phase="end", span=self._switch_count)
            tm.metrics.observe("switch_stall_s", tm.clock() - t_switch)
        return report

    def _rollback_switch(self, old, old_devices, torn_down, origin,
                         exported, drained, err) -> SwitchReport:
        """Undo a failed commit: pull every request back off the new
        engines (their pages ride another free handoff), rebuild the old
        configuration, and restore each request to its origin replica."""
        # 1) re-export whatever already landed on a new engine; unchanged
        #    replicas (also present in `old`) keep serving untouched
        keep = {id(h) for h in old}
        recovered: list[InflightSnapshot] = []
        for h in self.replicas:
            if id(h) in keep:
                continue
            recovered.extend(h.engine.export_inflight(release=False))
            self._prefill_tokens_retired += h.engine.prefill_tokens
            self.shed_rids.extend(h.engine.shed_rids)
            h.engine.release_all()
        # 2) plus everything never restored: exported snapshots whose rid
        #    did not land on a new engine (adopted snapshots were neutered,
        #    so matching by rid avoids double-restoring them)
        got = {s.rid for s in recovered}
        recovered += [s for s in exported if s.rid not in got]
        # 3) rebuild the torn-down replicas under their OLD configs; the
        #    handles (and their span counters) survive, only engines swap
        for h in torn_down:
            h.engine = self._build_engine(
                h.rc, old_devices.get(h.index) if self.shard else None,
                index=h.index)
            self._wire_faults(h)
        self.replicas = list(old)
        if self.shard:
            self._replica_devices = old_devices
        if self._applied_fractions is not None:
            self.router.reconfigure(self._applied_fractions)
        # 4) hand every request back to the replica it came from (pages
        #    were kept throughout, so the return trip is free again)
        rb = MigrationReport()
        by_origin: dict[int, list[InflightSnapshot]] = {}
        index_map = {h.index: h for h in old}
        tm = self.telemetry
        for s in recovered:
            h = origin.get(s.rid)
            if h is None or h.dead:        # no origin to return to: shed
                release_snapshot_pages(s)
                self.shed_rids.append(s.rid)
                rb.dropped += 1
                if tm.enabled:
                    tm.emit("shed", rid=s.rid, reason="capacity")
                    tm.metrics.count("shed_capacity")
                continue
            by_origin.setdefault(h.index, []).append(s)
            self.rid_owner[s.rid] = h.index
        for k, group in sorted(by_origin.items()):
            rep_k = migrate_batch(index_map[k].engine, group)
            self._emit_migrations(rep_k, k, {})
            rb.merge(rep_k)
        self._revert_orchestrator()
        report = SwitchReport([], drained, rb.migrated, rb.requeued,
                              handoff=rb.handoff, copied=rb.copied,
                              reprefilled=rb.reprefilled,
                              pages_handoff=rb.pages_handoff,
                              pages_copied=rb.pages_copied,
                              recompute_tokens=rb.recompute_tokens,
                              dropped=rb.dropped,
                              rolled_back=True, failure=f"commit: {err}")
        self.switch_reports.append(report)
        return report

    def _emit_migrations(self, rep: MigrationReport, dst: int,
                         src_idx: dict[int, int],
                         kind: str = "migrate") -> None:
        """Telemetry: one ``migrate``/``rebalance``/``handoff`` event per
        restored request (``kind`` distinguishes switch/crash migrations
        from mid-span rebalancer moves and disaggregated prefill→decode
        hops; all render as flow arrows).

        ``src_idx`` maps rid -> source replica index; requests without an
        entry (e.g. a rollback return trip of a request that never left)
        fall back to ``dst`` — the trace exporter overrides the source
        with the request's actually-open residency track anyway."""
        tm = self.telemetry
        if not tm.enabled:
            return
        for rid, (path, pages) in rep.paths.items():
            tm.emit(kind, rid=rid, src=src_idx.get(rid, dst),
                    dst=dst, path=path, pages=pages)
            tm.metrics.count(f"{kind}_{path}")

    def _revert_orchestrator(self) -> None:
        """Point the orchestrator's deployment state back at what the
        cluster actually runs after an aborted/rolled-back switch, so the
        next ``plan_span`` prices switches from reality."""
        if self.orch is not None:
            self.orch.on_switch_rollback(
                tuple(h.rc for h in self.replicas if not h.dead))

    # -- request flow -----------------------------------------------------------

    def _route(self, type_id: int, ctx_len: int, new_tokens: int,
               phase: str = "prefill") -> int:
        """Pick a live, admitting replica whose context ceiling fits the
        request; -1 when no replica can ever serve it (router state
        untouched).

        ``phase`` applies the disaggregated-role gate: new (prefill-phase)
        requests avoid ``decode`` replicas and decode-phase snapshots avoid
        ``prefill`` replicas.  The gate is a preference, not a law — when
        no role-compatible replica is up, the base mask wins, so a prefill
        replica's death can still recover its in-flight requests onto
        whatever survives (degrade, never wedge)."""
        up = np.array([not h.dead and h.engine.admitting
                       and h.engine.fits(ctx_len, new_tokens)
                       for h in self.replicas])
        if not up.any():
            return -1
        avoid = "decode" if phase == "prefill" else "prefill"
        preferred = up & np.array(
            [h.rc.role != avoid for h in self.replicas])
        if preferred.any():
            up = preferred
        if self.faults is not None:
            # injected traffic skew: all submissions pile onto one replica
            # while it is up (the hot spot the rebalancer must relieve)
            b = self.faults.route_bias(self._tick)
            if b is not None and b < len(up) and up[b]:
                return b
        self.router.update_loads(
            [h.engine.load_stats()["load"] for h in self.replicas])
        return self.router.route(type_id, up)

    def submit(self, rid: int, prompt: np.ndarray, max_new_tokens: int,
               type_id: int = 0, ttft_deadline: float | None = None,
               tpot_deadline: float | None = None,
               priority: int = 0) -> int:
        """Route one typed request to a replica; returns the replica index.

        ``ttft_deadline`` (absolute, engine clock) arms SLO-aware shedding:
        the destination replica rejects the request if the deadline passes
        before its prefill starts.  ``tpot_deadline`` (seconds per output
        token) arms the decode-side counterpart: a request whose average
        token pace blows the budget is shed mid-flight.  Both are counted
        in ``load_stats`` / ``finish_span``.  ``priority`` (higher = more
        important) orders admission on the destination engine and — with
        the rebalancer enabled — lets a queued high-priority request
        preempt lower-priority residents instead of shedding."""
        if not self.replicas:
            raise RuntimeError("no deployment applied yet (call apply_plan)")
        k = self._route(type_id, len(prompt), max_new_tokens)
        if k < 0:
            raise ValueError(
                f"request {rid}: context {len(prompt)} + {max_new_tokens} "
                f"new tokens exceeds every replica's context ceiling")
        self.replicas[k].engine.submit(rid, prompt, max_new_tokens,
                                       ttft_deadline=ttft_deadline,
                                       tpot_deadline=tpot_deadline,
                                       type_id=type_id, priority=priority)
        # book-keep only after the engine accepted the request, so rejected
        # submissions don't pollute the observed-rate feedback
        self.rid_type[rid] = type_id
        if type_id < self.n_types:
            self._span_type_counts[type_id] += 1
        self.rid_owner[rid] = k
        self.request_log[rid] = _RequestLog(
            np.asarray(prompt, np.int32), max_new_tokens, [],
            ttft_deadline=ttft_deadline, tpot_deadline=tpot_deadline,
            priority=priority)
        return k

    def _record_finish(self, r: EngineRequest,
                       owner: ReplicaHandle | None = None) -> None:
        self.results[r.rid] = r
        self._span_completed += 1
        if owner is not None:
            owner.completed_span += 1
        self._log_tokens(r.rid, r.generated)

    # -- request log (last-resort recovery source) ------------------------------

    def _log_tokens(self, rid: int, generated: list) -> None:
        lg = self.request_log.get(rid)
        if lg is not None:
            lg.emitted[:] = list(generated)

    def _sync_log(self, eng: ServingEngine) -> None:
        """Top up the host-side token log after a replica's sync phase: the
        log must always hold every token the cluster has seen, because a
        later untrusted-pages failure rebuilds requests purely from it."""
        for r in eng.active.values():
            self._log_tokens(r.rid, r.generated)

    def _snapshot_from_log(self, rid: int) -> InflightSnapshot:
        lg = self.request_log[rid]
        return InflightSnapshot(rid, lg.prompt, list(lg.emitted),
                                lg.max_new_tokens,
                                deadline=lg.ttft_deadline,
                                tpot=lg.tpot_deadline,
                                priority=lg.priority)

    def step(self) -> list[EngineRequest]:
        """One cluster tick: step every replica that has work (round-robin).

        Dispatch-then-sync: phase 1 fires every replica's fused decode
        (``step_async``) without reading anything back; phase 2 syncs each
        pending token block (``finish_step``) and retires.  The host never
        blocks on replica i's device→host transfer before dispatching
        replica i+1, so the transfers and the host-side scheduling overlap
        the queued device work (the replicas' kernels still run one after
        another on the card — see the module docstring).

        Failure handling (see the module docstring's failure model): a
        ``ReplicaCrash`` at dispatch kills the replica and recovers its
        requests onto survivors; other dispatch errors (transient faults,
        admission OOMs) are retried with exponential backoff up to
        ``max_retries`` consecutive failures; an injected sync-phase
        fault kills the replica with its pages untrusted — the host
        ``seq_lens`` already advanced at dispatch, so a replica that cannot
        sync is a replica whose device state disagrees with the host — and
        its requests rebuild from the request log.  Other errors (CUDA
        errors among them) propagate.
        """
        self._tick += 1
        finished: list[EngineRequest] = []
        pending = []
        dispatched: set[int] = set()
        had_work: dict[int, bool] = {}
        for h in self.replicas:
            if h.dead:
                continue
            eng = h.engine
            busy = len(eng.active)
            h.slot_ticks += busy          # expected: ~1 token / slot / tick
            work = bool(eng.active or (eng.waiting and eng.admitting))
            had_work[h.index] = work
            if not work:
                continue
            h.work_ticks += 1
            if h.period > 1 and self._tick % h.period:
                continue                  # injected straggler skips this tick
            if (self.faults is not None
                    and self.faults.stalled(self._tick, h.index)):
                continue                  # injected stall: frozen, no error
            if self._tick < h.backoff_until:
                # backing off after a failure: intentional non-progress, so
                # the watchdog must not count it
                had_work[h.index] = False
                continue
            try:
                if self.faults is not None:
                    spec = self.faults.dispatch_fault(self._tick, h.index)
                    if spec is not None:
                        raise error_for(spec)
                pend = eng.step_async()
            except ReplicaCrash as e:
                self._fail(h, e, trust_pages=not e.lose_pages)
                continue
            except (FaultError, MemoryError) as e:
                self._transient(h, e)
                continue
            h.failures = 0
            h.progress_ticks += 1
            dispatched.add(h.index)
            pending.append((h, eng.tokens_out, pend))
        if self.rebalance is not None:
            # the async overlap window: every dispatch is in flight, no
            # sync has read anything back.  Draining a zero-progress
            # replica here is safe — it has no pending dispatch to race
            # with, and imports land in destination slots outside any
            # pending decode's captured batch.
            self._moves_left = self.rebalance.max_moves_per_tick
            self._watchdog(dispatched, had_work)
        for h, t0, pend in pending:
            try:
                done = h.engine.finish_step(pend)
            except (FaultError, MemoryError) as e:
                self._fail(h, e, trust_pages=False)
                continue
            for r in done:
                self._record_finish(r, owner=h)
                finished.append(r)
            h.emitted_span += h.engine.tokens_out - t0
            self._sync_log(h.engine)
        self._handoff_post()
        if self.rebalance is not None:
            self._rebalance_post()
        self._drain_prefix_events()
        return finished

    def _handoff_post(self) -> None:
        """Disaggregated prefill→decode handoff, run post-sync each tick.

        Every live ``prefill``-role replica hands its first-token-ready
        sequences (prefill complete, >= 1 token emitted, output remaining)
        to a ``decode`` replica — ``mixed`` as the fallback — through the
        same export / ``migrate_batch`` machinery switches, recovery and
        the rebalancer use.  With the shared pool this is a pure
        page-ownership transfer (zero tokens recomputed, zero bytes
        moved).  There is deliberately no per-tick budget: a
        prefill replica's whole point is to clear its slots for the next
        prompt, so throttling handoffs would just rebuild the admission
        bottleneck the role split exists to remove.  A sequence with no
        eligible destination keeps decoding in place until one appears."""
        for h in self.replicas:
            if h.dead or h.degraded or h.rc.role != "prefill":
                continue
            eng = h.engine
            ready = [r for _, r in sorted(eng.active.items())
                     if not r.prefilling and r.generated
                     and r.max_new_tokens - len(r.generated) >= 1]
            for r in ready:
                dst = (self._pick_dst(h, r, roles=("decode",))
                       or self._pick_dst(h, r, roles=("mixed",)))
                if dst is None:
                    continue
                snap = eng.export_request(r.rid, release=False)
                if snap is None:
                    continue
                self._log_tokens(snap.rid, snap.generated)
                rep = migrate_batch(dst.engine, [snap])
                self._emit_migrations(rep, dst.index,
                                      {snap.rid: h.index}, kind="handoff")
                self._span_handoff.merge(rep)
                eng.handoff_out += 1
                dst.engine.handoff_in += 1
                self._span_handoffs += 1
                self.rid_owner[snap.rid] = dst.index

    def _caches(self) -> list:
        """Distinct ``PrefixCache`` objects behind the live engines (one for
        a shared pool, one per replica when sharded)."""
        seen: dict[int, object] = {}
        for h in self.replicas:
            pc = h.engine.prefix_cache
            if pc is not None:
                seen[id(pc)] = pc
        return list(seen.values())

    def _drain_prefix_events(self) -> None:
        """Fold every engine's per-admission cache events into the span's
        per-type token accounting (dead engines included — their events may
        predate the death)."""
        for h in self.replicas:
            ev = h.engine.prefix_events
            if not ev:
                continue
            for rid, cached, ctx in ev:
                j = self.rid_type.get(rid, 0)
                if j < self.n_types:
                    self._span_hit_tokens[j] += cached
                    self._span_ctx_tokens[j] += ctx
            h.engine.prefix_events = []

    @property
    def pending(self) -> int:
        return (sum(len(h.engine.waiting) + len(h.engine.active)
                    for h in self.replicas)
                + len(self._evicted))

    def run_until_idle(self, max_ticks: int = 10_000,
                       strict: bool = True) -> list[EngineRequest]:
        """Step until no request is waiting or active anywhere.

        Raises ``ClusterHangError`` if ``max_ticks`` is exhausted with
        requests still pending — a wedged cluster must surface instead of
        masquerading as completion (``strict=False`` restores the old
        return-what-finished behavior for callers that poll)."""
        finished = []
        ticks = 0
        while self.pending and ticks < max_ticks:
            finished.extend(self.step())
            ticks += 1
        if self.pending and strict:
            stats = [(h.index, len(h.engine.waiting), len(h.engine.active),
                      "dead" if h.dead else "live") for h in self.replicas]
            raise ClusterHangError(
                f"run_until_idle exhausted {max_ticks} ticks with "
                f"{self.pending} requests still pending; per-replica "
                f"(index, waiting, active, state): {stats}")
        return finished

    # -- live rebalancing (mid-span migration / preemption) ----------------------

    def _watchdog(self, dispatched: set, had_work: dict) -> None:
        """Straggler escape, run inside the dispatch→sync overlap window.

        Counts consecutive ticks a replica had work but fired no dispatch
        (an injected ``stall``/``slow``, a real frozen device — backoff
        skips are intentional and excluded).  At ``watchdog_ticks`` the
        replica degrades: admission pauses and its requests drain onto
        survivors under the move budget; a later successful dispatch
        un-degrades it.  After ``escalate_ticks`` of sustained
        degradation the replica is failed for real — the export is safe
        (``trust_pages=True``) because nothing was dispatched during the
        freeze, so host and device state agree."""
        rb = self.rebalance
        tm = self.telemetry
        for h in list(self.replicas):
            if h.dead:
                continue
            if h.index in dispatched:
                h.no_progress = 0
                if h.degraded:
                    # progress again (e.g. the stall window ended): rejoin
                    h.degraded = False
                    h.engine.resume_admission()
                continue
            if h.degraded:
                self._drain_degraded(h)
                if self._tick - h.degraded_tick >= rb.escalate_ticks:
                    self._fail(h, RuntimeError(
                        f"watchdog: replica {h.index} made no progress "
                        f"for {self._tick - h.degraded_tick} ticks after "
                        f"degradation"), trust_pages=True)
                continue
            if not had_work.get(h.index):
                continue
            h.no_progress += 1
            if h.no_progress < rb.watchdog_ticks:
                continue
            h.degraded = True
            h.degraded_tick = self._tick
            h.engine.pause_admission()
            if tm.enabled:
                tm.emit("degraded", replica=h.index, ticks=h.no_progress)
                tm.metrics.count("replica_degraded")
            self._drain_degraded(h)

    def _drain_degraded(self, h: ReplicaHandle) -> None:
        """Best-effort drain of a degraded replica under the move budget.

        Queued requests first (they move for free — token state only),
        then residents (page handoff).  Whatever does not fit a survivor
        this tick is retried next tick, and the escalation path recovers
        any leftovers."""
        eng = h.engine
        for r in list(eng.waiting):
            if self._moves_left <= 0:
                return
            self._move_request(h, r)
        for slot in sorted(eng.active):
            if self._moves_left <= 0:
                return
            r = eng.active.get(slot)
            if r is not None:
                self._move_request(h, r)

    def _pick_dst(self, src_h: ReplicaHandle, r: EngineRequest,
                  max_load: float | None = None,
                  roles: tuple | None = None) -> ReplicaHandle | None:
        """Least-loaded live survivor that can hold ``r`` *right now*:
        free slot + page/quota capacity for page-resident sequences
        (pre-checked so a handoff never degrades into a surprise
        re-prefill), just the context-ceiling fit for queued ones.

        ``roles`` restricts candidates to those replica roles (the
        prefill→decode handoff asks for ``("decode",)`` first); when None,
        the phase-compatibility gate applies — a decode-phase request
        never lands on a ``prefill`` replica and a prefill-phase one never
        lands on a ``decode`` replica."""
        eng = src_h.engine
        ctx = len(r.prompt) + len(r.generated)
        remaining = r.max_new_tokens - len(r.generated)
        if remaining < 1:
            return None
        total = ctx + remaining - 1
        resident = not r.prefilling and r.slot in eng.cache.seq_blocks
        n_blocks = n_shared = 0
        if resident:
            n_blocks = len(eng.cache.seq_blocks[r.slot])
            n_shared = eng.cache.seq_shared.get(r.slot, 0)
        decode_phase = not r.prefilling and bool(r.generated)
        best, best_load = None, None
        for h in self.replicas:
            if h is src_h or h.dead or h.degraded:
                continue
            if roles is not None:
                if h.rc.role not in roles:
                    continue
            elif ((h.rc.role == "decode" and not decode_phase)
                  or (h.rc.role == "prefill" and decode_phase)):
                continue
            e = h.engine
            if not e.admitting or not e.fits(ctx, remaining):
                continue
            if resident:
                if len(e.active) >= e.max_seqs:
                    continue
                if e.cache.pool is eng.cache.pool:
                    if not e.cache.can_adopt(n_blocks, total,
                                             n_shared=n_shared):
                        continue
                elif not e.cache.can_admit(ctx, total):
                    continue
            load = e.load_stats()["load"]
            if max_load is not None and load > max_load:
                continue
            if best_load is None or load < best_load:
                best, best_load = h, load
        return best

    def _move_request(self, src_h: ReplicaHandle, r: EngineRequest,
                      max_load: float | None = None) -> bool:
        """Migrate one request off ``src_h`` through the cheapest path;
        returns True (and spends one budget unit) when it moved."""
        dst = self._pick_dst(src_h, r, max_load=max_load)
        if dst is None:
            return False
        snap = src_h.engine.export_request(r.rid, release=False)
        if snap is None:
            return False
        self._log_tokens(snap.rid, snap.generated)
        rep = migrate_batch(dst.engine, [snap])
        self._emit_migrations(rep, dst.index, {snap.rid: src_h.index},
                              kind="rebalance")
        self._span_rebalance.merge(rep)
        src_h.engine.rebalanced_out += 1
        dst.engine.rebalanced_in += 1
        self._span_rebalanced += 1
        self.rid_owner[snap.rid] = dst.index
        self._moves_left -= 1
        return True

    def _rebalance_post(self) -> None:
        """Post-sync rebalancing, under whatever is left of the tick's
        move budget: resume preemption-evicted requests, relieve hot
        spots, then run the priority-preemption ladder."""
        self._resume_evicted()
        self._relieve_hotspots()
        if self.rebalance.preempt:
            for h in list(self.replicas):
                if self._moves_left <= 0:
                    return
                if not h.dead and not h.degraded:
                    self._preempt(h)

    def _relieve_hotspots(self) -> None:
        """Move load off replicas with deep queues or KV pressure, onto
        survivors at or below ``cold_load``.  Queued never-prefilled
        requests move first (free); else the smallest resident sequence
        rides a page handoff."""
        rb = self.rebalance
        for h in list(self.replicas):
            if self._moves_left <= 0:
                return
            if h.dead or h.degraded:
                continue
            eng = h.engine
            cap = eng.cache.quota or eng.cache.num_blocks
            hot = (len(eng.waiting) >= rb.hot_queue
                   or eng.cache.n_free_blocks / max(cap, 1)
                   < rb.hot_kv_frac)
            if not hot:
                continue
            moved = False
            for r in list(eng.waiting):
                if not r.generated:        # free move: nothing computed yet
                    moved = self._move_request(h, r, max_load=rb.cold_load)
                    if moved:
                        break
            if moved:
                continue
            for r in sorted((r for r in eng.active.values()
                             if not r.prefilling
                             and r.max_new_tokens - len(r.generated) >= 1),
                            key=lambda r: len(r.prompt) + len(r.generated)):
                if self._move_request(h, r, max_load=rb.cold_load):
                    break

    def _preempt(self, h: ReplicaHandle) -> None:
        """Relocation > eviction > shedding, for a queued high-priority
        request its replica cannot admit.

        The cheapest lower-priority resident victim is migrated to a
        survivor if one can hold it; otherwise it is *evicted* — exported
        to the host request log with its pages freed, parked in
        ``_evicted``, and resumed later by re-prefill wherever genuine
        room appears (zero emitted tokens lost).  Only if the ladder
        cannot act does the waiter face ordinary SLO shedding."""
        eng = h.engine
        if not eng.waiting:
            return
        waiter = max(eng.waiting, key=lambda r: r.priority)
        if waiter.priority <= 0:
            return
        ctx = len(waiter.prefill_tokens)
        total = ctx + (waiter.max_new_tokens - len(waiter.generated)) - 1
        if (len(eng.active) < eng.max_seqs
                and eng.cache.can_admit(ctx, total)):
            return                      # admission will take it anyway
        victims = [r for r in eng.active.values()
                   if not r.prefilling and r.priority < waiter.priority
                   and r.max_new_tokens - len(r.generated) >= 1]
        if not victims:
            return
        victim = min(victims, key=lambda r: (r.priority,
                                             len(r.prompt)
                                             + len(r.generated)))
        rid = victim.rid
        if self._move_request(h, victim):
            action = "relocate"
        else:
            snap = eng.export_request(rid, release=True)
            if snap is None:
                return
            self._log_tokens(snap.rid, snap.generated)
            self._evicted[rid] = h.index
            self._moves_left -= 1
            action = "evict"
        eng.preempted += 1
        self._span_preempted += 1
        if self.telemetry.enabled:
            self.telemetry.emit("preempt", rid=rid, replica=h.index,
                                action=action, for_rid=waiter.rid)
            self.telemetry.metrics.count(f"preempt_{action}")

    def _resume_evicted(self) -> None:
        """Re-admit preemption-evicted requests from the host log onto
        whichever replica has genuine room (free slot + pages), least
        loaded first.  A request no survivor can ever fit is shed —
        degrade, never wedge; one that just has to wait stays parked."""
        if not self._evicted:
            return
        tm = self.telemetry
        for rid, src in list(self._evicted.items()):
            if self._moves_left <= 0:
                return
            lg = self.request_log[rid]
            ctx = len(lg.prompt) + len(lg.emitted)
            remaining = lg.max_new_tokens - len(lg.emitted)
            if remaining < 1:        # the log already holds the output
                del self._evicted[rid]
                self._record_finish(EngineRequest(
                    rid, lg.prompt, lg.max_new_tokens,
                    generated=list(lg.emitted), done=True))
                if tm.enabled:
                    tm.emit("finish_log", rid=rid, tokens=len(lg.emitted))
                continue
            ever = [h for h in self.replicas if not h.dead
                    and h.engine.fits(ctx, remaining)]
            if not ever:
                del self._evicted[rid]
                self.shed_rids.append(rid)
                if tm.enabled:
                    tm.emit("shed", rid=rid, reason="capacity")
                    tm.metrics.count("shed_capacity")
                continue
            best, best_load = None, None
            total = ctx + remaining - 1
            # role gate as a preference: a phase-incompatible replica is
            # only used when no compatible one has room (degrade > park)
            avoid = "prefill" if lg.emitted else "decode"
            for relax in (False, True):
                for h in ever:
                    e = h.engine
                    if h.degraded or not e.admitting:
                        continue
                    if not relax and h.rc.role == avoid:
                        continue
                    if (len(e.active) >= e.max_seqs
                            or not e.cache.can_admit(ctx, total)):
                        continue
                    load = e.load_stats()["load"]
                    if best_load is None or load < best_load:
                        best, best_load = h, load
                if best is not None:
                    break
            if best is None:
                continue             # no room yet: retry next tick
            snap = self._snapshot_from_log(rid)
            del self._evicted[rid]
            rep = migrate_batch(best.engine, [snap])
            self._emit_migrations(rep, best.index, {rid: src},
                                  kind="rebalance")
            self._span_rebalance.merge(rep)
            best.engine.rebalanced_in += 1
            self._span_rebalanced += 1
            self.rid_owner[rid] = best.index
            self._moves_left -= 1

    # -- failure detection & recovery -------------------------------------------

    def _transient(self, h: ReplicaHandle, err: Exception) -> None:
        """Bounded retry-with-backoff for dispatch-phase failures."""
        h.failures += 1
        self._span_retries += 1
        if h.failures > self.max_retries:
            # escalation: repeated failures == dead.  The failures all hit
            # at dispatch (pre-mutation), so the engine state is consistent
            # and the pages remain trustworthy.
            self._fail(h, err, trust_pages=True)
            return
        h.backoff_until = self._tick + (1 << (h.failures - 1))

    def fail_replica(self, k: int, lose_pages: bool = False,
                     reason: str = "operator kill") -> MigrationReport:
        """Declare replica ``k`` dead (ops/chaos entry point) and recover
        its requests onto survivors; returns what the recovery did."""
        return self._fail(self.replicas[k], RuntimeError(reason),
                          trust_pages=not lose_pages)

    def _fail(self, h: ReplicaHandle, err: Exception,
              trust_pages: bool) -> MigrationReport:
        """Declare a replica dead and recover its requests onto survivors.

        ``trust_pages=True`` (the failure hit before dispatch, so engine
        state is consistent): exported snapshots keep their KV pages and
        survivors adopt them via handoff — zero tokens recomputed.
        ``trust_pages=False`` (device state lost or out of sync with the
        host): token snapshots rebuild from the cluster's
        request log and survivors re-prefill — zero emitted tokens lost
        either way.  Requests no survivor can hold are shed, never wedged.
        The dead handle stays in ``replicas`` (masked everywhere) until
        the next ``apply_plan`` rebuilds or drops it.
        """
        if h.dead:
            return MigrationReport()
        tm = self.telemetry
        t_fail = tm.clock() if tm.enabled else 0.0
        if tm.enabled:
            tm.emit("crash", replica=h.index, step=self._tick,
                    exc=type(err).__name__)
            tm.metrics.count("replica_crashes")
        h.dead = True
        self._span_dead.append(h.index)
        self.dead_replicas.append(h.index)
        self.lost_chips += h.rc.chips
        eng = h.engine
        if trust_pages:
            snaps = eng.export_inflight(release=False)
            for s in snaps:
                self._log_tokens(s.rid, s.generated)
        else:
            rids = ([r.rid for r in eng.active.values()]
                    + [r.rid for r in eng.waiting])
            # allocator accounting is host-side and still sound: hand every
            # block back, then rebuild purely from the host token log
            eng.release_all()
            snaps = [self._snapshot_from_log(rid) for rid in rids]
        # fold the dead engine's counters into the cluster totals exactly
        # once (the handle stays visible until the next apply_plan)
        self.shed_rids.extend(eng.shed_rids)
        eng.shed_rids = []
        h.shed_mark = 0
        self._prefill_tokens_retired += eng.prefill_tokens
        eng.prefill_tokens = 0
        eng.pause_admission()
        if self.shard:
            slice_ = self._replica_devices.pop(h.index, ())
            if slice_:
                # keep the slice around: repair_replica re-admits it (the
                # chaos model fails replicas, not the silicon under them)
                self._dead_devices[h.index] = tuple(slice_)
                gone = set(slice_)
                self._chips = [c for c in self._chips if c not in gone]
        rep = self._recover(snaps, src=h.index)
        self._span_recovery.merge(rep)
        if tm.enabled:
            stall = tm.clock() - t_fail
            tm.metrics.observe("recovery_stall_s", stall)
            tm.emit("recovered", replica=h.index, n=len(snaps),
                    stall_s=stall)
        return rep

    def repair_replica(self, k: int) -> None:
        """Rebuild dead replica ``k`` under its existing config and re-admit
        its chips to the planning budget (ops/rejoin entry point; the
        inverse of ``_fail``).

        The repaired engine starts empty — its old requests were already
        recovered onto survivors at death — but with the shared-pool prefix
        cache it starts *warm*: the index outlived the engine.  When an
        orchestrator is attached, ``observe_rejoin`` restores the chips to
        its ``ClusterSpec`` and inserts a neutral health entry, so the next
        ``plan_span`` re-solves over the recovered capacity.
        """
        h = self.replicas[k]
        if not h.dead:
            return
        chips = None
        if self.shard:
            chips = self._dead_devices.pop(k, None)
            if chips is None:
                raise ValueError(
                    f"replica {k}: no stashed device slice to rejoin "
                    f"(its devices were never recorded at failure)")
            self._chips.extend(chips)
            self._replica_devices[k] = tuple(chips)
        h.engine = self._build_engine(h.rc, chips, index=k)
        self._wire_faults(h)
        h.dead = False
        h.failures = 0
        h.backoff_until = 0
        h.no_progress = 0
        h.degraded = False
        h.degraded_tick = 0
        h.slot_ticks = h.emitted_span = h.completed_span = 0
        h.work_ticks = h.progress_ticks = 0
        h.shed_mark = 0
        self.lost_chips -= h.rc.chips
        self.repaired_replicas.append(k)
        # a same-span death that was repaired before finish_span must not
        # still shrink the planning budget
        if k in self._span_dead:
            self._span_dead.remove(k)
        if self.orch is not None:
            live = tuple(hh.rc for hh in self.replicas if not hh.dead)
            idx = sum(1 for hh in self.replicas[:k] if not hh.dead)
            self.orch.observe_rejoin(live, self.surviving_chips,
                                     health_index=idx)

    def _recover(self, snaps: list[InflightSnapshot],
                 src: int = -1) -> MigrationReport:
        """Restore a dead replica's requests on survivors, cheapest path
        first (the same migration machinery planned switches use).
        ``src`` labels the originating (dead) replica on trace events."""
        rep = MigrationReport()
        if not snaps:
            return rep
        by_dest, dropped = self._route_snapshots(snaps)
        rep.dropped += len(dropped)
        for k, group in sorted(by_dest.items()):
            rep_k = migrate_batch(self.replicas[k].engine, group)
            self._emit_migrations(rep_k, k, {s.rid: src for s in group})
            rep.merge(rep_k)
        return rep

    def _route_snapshots(self, snaps: list[InflightSnapshot]
                         ) -> tuple[dict[int, list[InflightSnapshot]],
                                    list[int]]:
        """Route exported snapshots to live replicas that can hold them,
        grouped per destination; unplaceable ones are released and shed
        (returned as the dropped rid list) — degrade, never wedge."""
        by_dest: dict[int, list[InflightSnapshot]] = {}
        dropped: list[int] = []
        for s in snaps:
            ctx = len(s.prompt) + len(s.generated)
            remaining = s.max_new_tokens - len(s.generated)
            if remaining < 1:
                # the log already holds the full output: finish it here
                release_snapshot_pages(s)
                self._record_finish(EngineRequest(
                    s.rid, np.asarray(s.prompt, np.int32),
                    s.max_new_tokens, generated=list(s.generated),
                    done=True))
                if self.telemetry.enabled:
                    self.telemetry.emit("finish_log", rid=s.rid,
                                        tokens=len(s.generated))
                continue
            k = self._route(self.rid_type.get(s.rid, 0), ctx, remaining,
                            phase="decode" if s.generated else "prefill")
            if k < 0:
                release_snapshot_pages(s)
                self.shed_rids.append(s.rid)
                dropped.append(s.rid)
                if self.telemetry.enabled:
                    self.telemetry.emit("shed", rid=s.rid,
                                        reason="capacity")
                    self.telemetry.metrics.count("shed_capacity")
                continue
            by_dest.setdefault(k, []).append(s)
            self.rid_owner[s.rid] = k
        return by_dest, dropped

    # -- observation / feedback -------------------------------------------------

    def set_throttle(self, k: int, fraction: float) -> None:
        """Make replica ``k`` a straggler: it steps only ``fraction`` of the
        cluster ticks (chaos injection for the health feedback loop)."""
        self.replicas[k].period = max(1, int(round(1.0 / max(fraction, 1e-6))))

    def load_stats(self) -> list[dict]:
        stats = []
        for h in self.replicas:
            d = h.engine.load_stats()
            d["dead"] = h.dead
            stats.append(d)
        return stats

    def finish_span(self) -> SpanReport:
        """Close the span: report achieved/expected throughput per replica
        and realized per-type rates back to the orchestrator.

        Dead replicas score 0.  A live replica that shed requests this
        span (TTFT or TPOT SLO misses) has its achieved fraction scaled by
        completed/(completed+shed): persistent SLO pressure shrinks the
        capacity the next assignment gives it, the same feedback channel a
        straggler's low token throughput uses.  When replicas died this
        span, their chips leave the planning budget via
        ``Orchestrator.observe_failures`` so the next ``plan_span``
        re-solves over the survivors."""
        achieved = []
        for h in self.replicas:
            if h.dead:
                achieved.append(0.0)
                continue
            if h.rc.role == "prefill":
                # token throughput under-measures a prefill replica (its
                # sequences leave at first token); liveness — did it
                # dispatch whenever it had work — is the honest signal,
                # and still degrades a stalled/straggling one
                base = (1.0 if h.work_ticks == 0
                        else min(1.0, h.progress_ticks / h.work_ticks))
            elif h.slot_ticks == 0:
                base = 1.0               # idle replica: no evidence of harm
            else:
                base = min(1.0, h.emitted_span / h.slot_ticks)
            shed_h = len(h.engine.shed_rids) - h.shed_mark
            if shed_h > 0:
                served = h.completed_span
                base *= served / (served + shed_h)
            achieved.append(base)
        span_shed = self.total_shed - self._span_shed_mark
        self._span_shed_mark = self.total_shed
        # prefix-cache span accounting: token-weighted per-type hit rate
        # (NaN = type saw no admissions, the orchestrator keeps its EWMA)
        # plus span deltas of the monotonic byte/hit counters
        self._drain_prefix_events()
        caches = self._caches()
        hit_rate = None
        d_hits = d_miss = d_evict = d_restore = 0
        if caches:
            with np.errstate(invalid="ignore"):
                hit_rate = self._span_hit_tokens / self._span_ctx_tokens
            totals = (sum(c.hits for c in caches),
                      sum(c.misses for c in caches),
                      sum(c.evicted_bytes for c in caches),
                      sum(c.restored_bytes for c in caches))
            d_hits, d_miss, d_evict, d_restore = (
                t - m for t, m in zip(totals, self._prefix_mark))
            self._prefix_mark = totals
        report = SpanReport(achieved, [h.emitted_span for h in self.replicas],
                            self._span_completed,
                            self._span_type_counts.copy(), shed=span_shed,
                            dead_replicas=list(self._span_dead),
                            retries=self._span_retries,
                            recovery=self._span_recovery,
                            prefix_hit_rate=hit_rate,
                            prefix_hits=d_hits, prefix_misses=d_miss,
                            prefix_evicted_bytes=d_evict,
                            prefix_restored_bytes=d_restore,
                            rebalanced=self._span_rebalanced,
                            preempted=self._span_preempted,
                            rebalance=self._span_rebalance,
                            handoffs=self._span_handoffs,
                            handoff=self._span_handoff,
                            role_util={
                                role: float(np.mean(vals))
                                for role in ("mixed", "prefill", "decode")
                                if (vals := [a for h, a in
                                             zip(self.replicas, achieved)
                                             if not h.dead
                                             and h.rc.role == role])})
        if self.telemetry.enabled:
            # join realized span numbers with the matching plan decision
            # (FIFO) so the audit can score prediction calibration
            self.telemetry.audit.record_realized(report)
        if self.orch is not None:
            self.orch.observe_health(achieved)
            self.orch.observe_rates(self._span_type_counts)
            if hit_rate is not None:
                self.orch.observe_prefix_hits(hit_rate)
            if self._span_dead:
                self.orch.observe_failures(self._span_dead,
                                           self.surviving_chips)
            # what a switch decided *now* would have to migrate; with one
            # shared pool migrations ride the free page-handoff path,
            # sharded runtimes pay the cross-pool reshard
            lens = [c for h in self.replicas if not h.dead
                    for c in h.engine.inflight_context_lens()]
            self.orch.observe_inflight(lens, shared_pool=not self.shard)
            if self.rebalance is not None:
                # churn feedback: mid-span moves raise the planner's
                # switch-hysteresis bar so the two loops don't fight
                self.orch.observe_rebalance(self._span_rebalanced
                                            + self._span_preempted)
        for h in self.replicas:
            h.slot_ticks = 0
            h.emitted_span = 0
            h.completed_span = 0
            h.work_ticks = 0
            h.progress_ticks = 0
            h.shed_mark = len(h.engine.shed_rids)
        self._span_completed = 0
        self._span_type_counts = np.zeros(self.n_types)
        self._span_hit_tokens = np.zeros(self.n_types)
        self._span_ctx_tokens = np.zeros(self.n_types)
        self._span_dead = []
        self._span_retries = 0
        self._span_recovery = MigrationReport()
        self._span_rebalanced = 0
        self._span_preempted = 0
        self._span_rebalance = MigrationReport()
        self._span_handoffs = 0
        self._span_handoff = MigrationReport()
        return report
