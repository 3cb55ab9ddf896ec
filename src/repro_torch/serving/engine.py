"""Continuous-batching serving engine (one model replica), PyTorch/CUDA.

The port of the JAX package's ``ServingEngine`` main path: admit prompts by
lifetime reservation while KV blocks remain, prefill them one-shot into the
paged pool (grouped by prompt length, so RoPE positions need no padding),
then step decode over the active set; finished sequences free their pages
immediately.  Prefill and decode interleave within a step.

Chunked prefill (``prefill_chunk_tokens``, Sarathi-style): a prompt longer
than the chunk streams into its pages chunk by chunk, one bounded token
budget per step shared round-robin over every mid-prefill sequence (each
share floored at a quarter of the budget); each chunk forward writes its
K/V into the pages and attends to the earlier chunks through the block
table (``models.prefill_chunk``, the prefill kernel with a query offset).
The decode batch keeps stepping meanwhile, one token per step while any
chunk is in flight.

Decode is device-resident: ``models.decode_loop_paged`` runs up to
``decode_horizon`` steps — paged attention through the hand-written kernel,
the K/V token write, sampling — with the tokens kept on the device, and
returns a ``[B, H]`` token block read back with **one device→host transfer
per horizon** (``decode_syncs`` counts them).  Batches are padded to
power-of-two buckets with the trash slot, page counts to power-of-two
buckets, and the horizon to a power-of-two floor of the safe step count
(``min(decode_horizon, min remaining max_new_tokens)``, collapsed to 1 on a
step that admitted a request).  Page capacity for the whole horizon is
pre-extended against the admission-time reservation, so the device loop
never needs a host allocation.  Under greedy decoding the token stream is
the same for every horizon.

``step_async()`` runs the host scheduling and fires the decode without
reading it back; ``finish_step(pending)`` performs the transfer and
retirement; ``step()`` is their composition.

The compiled step (``serving.graphs``), as the JAX engine jits its hot
path: on an unsharded paged engine the whole device half of a decode
horizon (the slots' table, lens and SSM row gathers, the loop, the
scatter back and the trash slot's lens pinned to 0) is one step per
(batch bucket, page bucket, horizon), and on any unsharded engine a chunk
forward is one per (chunk bucket, page bucket) with ``start`` and
``n_valid`` as device scalars.
On the card the first call of a key runs eagerly and is then captured as
a CUDA graph; later calls copy their inputs into the key's buffers and
replay it (``graph_captures``, ``graph_replays``, ``capture_s``; not in
``load_stats()``).  On the CPU the same buffers are reused and nothing is
captured.  What stays eager, chosen by configuration: the one-shot
prefill (shaped per prompt length), the dense mode's decode (its gather
is sized per step by the longest context), sharded engines, and a sampled
decode (its per-step ``torch.Generator`` cannot be captured).  ``graphs=False`` runs it all
eagerly, with ``start``/``n_valid`` as host ints.

Models with SSM layers (mamba2, hymba) keep one SSM state and conv window
row per slot on the device: prefill writes a request's rows, each decode
dispatch gathers the batch's rows into the loop's state and scatters them
back, with padded rows on the trash row.  As in the JAX package, chunked
prefill and the prefix cache are attention-only (the SSD scan has no
per-position state to resume from).

The prefix cache (``prefix_cache=True``, ``serving.prefixcache``): at
admission a fresh prompt's leading full pages that the pool's index holds
are attached by reference count, and prefill starts at the first uncached
token (``prefill_pos``).  A prompt the cache covers whole keeps its last
token for the forward and copies its last matched page (copy-on-write).
The uncached suffix runs as one chunk forward (``models.prefill_chunk``,
the prefill kernel with a query offset), or through the chunk budget on a
chunking engine.  A sequence publishes its full pages to the index when its
context is all in pages and again at retirement, before it releases them.

``decode_mode="dense"`` is the JAX package's dense-gather baseline: each
step copies the batch's live K/V out of the pages into a dense cache
(``PagedKVCache.gather_dense``), runs one ``models.decode_step`` through
the dense decode kernel, writes the new token back into the pages and
reads the sampled tokens back at once (horizon 1; as in the JAX package
this path counts no ``decode_syncs``).

Replica lifecycle (``repro_torch.serving.migration`` and
``repro_torch.serving.cluster`` build on it): an engine may share its
``BlockPool`` with others (``pool=``, ``kv_quota=``), and then its prefix
index too.  ``pause_admission``/``resume_admission`` gate admission,
``drain`` finishes short sequences in place, and
``export_inflight``/``export_request`` evict requests as
``InflightSnapshot``s: token state only, or (``release=False``) with the
sequence's pages, disowned from this engine's view, and a copy of its SSM
rows, and how many of its leading pages it holds by reference
(``n_shared``).  ``import_by_pages`` adopts such a snapshot — by handoff
when it shares the pool, else by copying or re-laying out the pages — and
the request resumes decoding with nothing recomputed; ``import_inflight``
resumes it by re-prefilling ``prompt + generated``, which hits the prefix
cache like any admission.  A snapshot carries the request's TTFT deadline,
TPOT budget and priority.  Call export and import only between
``finish_step`` and the next ``step_async``: no decode may be in flight.

SLO shedding and priority, as in the JAX package: ``submit`` takes a TTFT
deadline (absolute, engine clock), a TPOT budget (seconds a token) and a
priority.  Admission sheds waiting requests whose deadline has passed
(``_shed_blown``) and admits higher priorities first; after retirement
each step sheds active requests whose pace since their first token blew
their budget (``_shed_slow``).  Shed rids land in ``shed_rids``.

Telemetry (``telemetry=``, ``serving.telemetry``): the engine emits the
JAX package's lifecycle events with the same fields (submit, admit,
prefix_hit, prefill_chunk, first_token, dispatch, sync, retire, shed) and
records the TTFT, TPOT and queue-delay histograms, all on the host at
scheduling boundaries; each emit point is guarded, so the disabled default
``NULL_TELEMETRY`` costs nothing.  ``clock=`` sets the one time source of
deadlines, pacing and events (else the telemetry's clock, else
``time.monotonic``); ``trace_id`` is the replica index on the trace and
``role`` the replica's serving role (the engine itself is role-blind; the
cluster routes and hands off).  ``fault_hook``, when set, is called as
``fault_hook("admit")`` before admission mutates anything and may raise
(the cluster's injected OOM).

``load_stats()`` returns every key of the frozen ``LOAD_STATS_KEYS``
schema (the JAX package's table).

Sharded replicas (``mesh=`` and ``shard_plan=``): the engine runs a
``models.sharded.ShardedModel`` over the replica's (pp, tp) mesh in place
of the plain model functions, over a sharded pool (``BlockPool`` with
``mesh=``) and, with SSM layers, sharded per-slot SSM rows; its host
scheduler, allocator and block tables are the same.  Where the JAX
package's sharded engine runs ``attn_impl="jnp"``, the port's shards run
the kernels (B1, B2 and its chunk form, B4) at their local head counts.
Snapshots carry a slot's SSM rows in their logical form, so a request
moves between unlike layouts with its state.  A page import picks its
route by the pools' ``placement`` and KV-head counts: copy (same
placement and geometry), relayout (same placement, another page size) or
``reshard_blocks`` (another mesh or head sharding).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import (DecodeCache, PagedDecodeState,
                                decode_loop_paged, decode_step, prefill,
                                prefill_chunk)
from repro_torch.models import sharded
from repro_torch.models.config import ModelConfig
from repro_torch.models.sampling import sample
from repro_torch.serving.graphs import StepGraphs, leaves
from repro_torch.serving.kvcache import (BlockPool, PagedKVCache,
                                         copy_blocks, relayout_blocks,
                                         reshard_blocks)
from repro_torch.serving.prefixcache import PrefixCache
from repro_torch.serving.telemetry import NULL_TELEMETRY

# the frozen load_stats() key set (the JAX package's schema)
LOAD_STATS_KEYS = frozenset({
    "waiting", "active", "max_seqs", "free_blocks",
    "free_blocks_effective", "tokens_out", "steps", "prefill_tokens",
    "prefix_hits", "prefix_misses", "prefix_hit_tokens",
    "prefix_evicted_bytes", "prefix_restored_bytes", "shed",
    "decode_syncs", "load",
    "rebalanced_in", "rebalanced_out", "preempted", "fragmentation",
    "handoff_in", "handoff_out",
})


@dataclasses.dataclass
class EngineRequest:
    rid: int
    prompt: np.ndarray           # int32 [S], the original prompt, always
    max_new_tokens: int
    slot: int = -1
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # a resumed (migrated) request prefills prompt + generated as one context
    ctx: np.ndarray | None = None
    prefill_pos: int = 0         # tokens of ``prefill_tokens`` in pages
    # SLO shedding: absolute TTFT deadline (engine clock) of a waiting
    # request, and the per-token pace budget (s/token) measured from t_first
    deadline: float | None = None
    tpot_budget: float | None = None
    t_first: float | None = None  # engine clock when the first token was read
    t_submit: float | None = None
    priority: int = 0             # higher first at admission

    @property
    def prefill_tokens(self) -> np.ndarray:
        return self.ctx if self.ctx is not None else self.prompt

    @property
    def prefilling(self) -> bool:
        """The context is not fully in pages yet.  A re-prefilling request
        is prefilling despite its non-empty ``generated``; an adopted one
        starts with ``prefill_pos`` at the end."""
        return self.prefill_pos < len(self.prefill_tokens)


@dataclasses.dataclass
class InflightSnapshot:
    """One evicted request, enough to resume it on any engine.

    The token fields alone serve the re-prefill restore.  A
    ``release=False`` export of a sequence past its prefill also carries
    its pages (which the snapshot now owns), their resident length, the
    pool they live in and a copy of its SSM rows; such pages must end
    adopted by an engine (``import_by_pages``) or released
    (``migration.release_snapshot_pages``).
    """
    rid: int
    prompt: np.ndarray
    generated: list
    max_new_tokens: int
    blocks: list | None = None       # physical page ids, sequence order
    seq_len: int = 0                 # tokens resident in those pages
    n_shared: int = 0                # leading prefix-cache pages (by ref)
    pool: BlockPool | None = None    # the pool the pages live in
    # the sequence's SSM rows, logical whatever the source's layout:
    # [L, H, P, N] fp32 and [L, W - 1, conv_ch] (``PagedKVCache.slot_rows``)
    ssm: torch.Tensor | None = None
    conv: torch.Tensor | None = None
    deadline: float | None = None    # TTFT deadline, carried across a move
    tpot: float | None = None        # TPOT pace budget, carried likewise
    priority: int = 0                # scheduling priority, carried likewise


@dataclasses.dataclass
class PendingDecode:
    """A dispatched-but-unsynced decode horizon: the device token block
    between ``step_async`` and ``finish_step``."""
    slots: list[int]
    tokens: torch.Tensor    # [B_bucket, horizon] on the device
    horizon: int


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, clipped to cap."""
    return min(cap, 1 << max(0, n - 1).bit_length())


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (n.bit_length() - 1)


def _canonical(device: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` name the same card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _token_snapshot(r: EngineRequest, **pages) -> InflightSnapshot:
    return InflightSnapshot(r.rid, r.prompt, list(r.generated),
                            r.max_new_tokens, deadline=r.deadline,
                            tpot=r.tpot_budget, priority=r.priority, **pages)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, num_blocks: int = 512,
                 block_size: int = 16, max_seqs: int = 8,
                 dtype=torch.float32, greedy: bool = True, seed: int = 0,
                 max_blocks_per_seq: int | None = None,
                 decode_horizon: int = 1, decode_mode: str = "paged",
                 prefill_chunk_tokens: int | None = None,
                 pool: BlockPool | None = None, kv_quota: int | None = None,
                 prefix_cache: bool = False, device="cuda",
                 mesh=None, shard_plan=None,
                 clock=None, telemetry=None, trace_id: int = 0,
                 role: str = "mixed", graphs: bool = True):
        """``params`` must already live on ``device``; ``dtype`` is the KV
        pool's dtype.  Runs on CUDA unless ``device="cpu"`` is passed.
        ``decode_mode`` is "paged" or "dense" (horizon 1 only);
        ``prefill_chunk_tokens`` turns on chunked prefill for prompts
        longer than it (ignored for models with SSM layers).  ``pool``
        shares a ``BlockPool`` with other engines (``num_blocks`` is then
        ignored), ``kv_quota`` caps the blocks this engine may reserve in
        it.  ``prefix_cache`` turns on the pool's prefix cache (ignored for
        models with SSM layers or no attention).  ``clock``,
        ``telemetry``, ``trace_id`` and ``role``: see the module
        docstring.  ``graphs=False`` runs the decode horizon and the chunk
        forward eagerly where the configuration would compile them (see
        the module docstring).

        ``mesh`` (``launch.mesh.make_replica_mesh``) + ``shard_plan``
        (``launch.sharding.make_plan(cfg, "serve", ...)``) run the replica
        sharded over the mesh's devices (``device`` is then its first);
        ``cfg``/``params`` must already be the plan's run config (head-
        padded in "pad" mode: ``launch.sharding.pad_attention_params``).
        A sharded engine is paged only, and a shared pool must live on the
        same mesh.  Every family runs sharded: attention heads, MLP d_ff,
        MoE experts or expert ff, SSM heads and vocab over the mesh's
        ``model`` axis, layers over ``pipe``."""
        if decode_mode not in ("paged", "dense"):
            raise ValueError(f"unknown decode_mode {decode_mode!r}")
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        if decode_horizon > 1 and decode_mode != "paged":
            raise ValueError("decode_horizon > 1 needs decode_mode='paged'")
        # chunked prefill resumes mid-prompt; the SSD scan has no
        # per-position state to resume from, so SSM archs prefill one-shot
        if prefill_chunk_tokens is not None and cfg.has_ssm:
            prefill_chunk_tokens = None
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1")
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self._mesh = mesh
        self._shard_plan = shard_plan
        self._prefill, self._prefill_chunk = prefill, prefill_chunk
        self._decode_loop = decode_loop_paged
        if mesh is not None:
            if shard_plan is None:
                raise ValueError("a sharded engine needs shard_plan "
                                 "(launch.sharding.make_plan(..., 'serve'))")
            if decode_mode != "paged":
                raise ValueError("sharded engines need decode_mode='paged'")
            self.params = sharded.ShardedModel.build(params, cfg,
                                                     shard_plan, mesh)
            self.device = mesh.first
            self._prefill = sharded.prefill
            self._prefill_chunk = sharded.prefill_chunk
            self._decode_loop = sharded.decode_loop_paged
        self.decode_mode = decode_mode
        self.decode_horizon = decode_horizon
        self.prefill_chunk_tokens = prefill_chunk_tokens
        if max_blocks_per_seq is None:
            max_blocks_per_seq = cfg.max_seq_len // block_size
        if pool is not None:
            if pool.mesh != mesh:
                raise ValueError("shared pool lives on a different mesh "
                                 "than this engine")
            if pool.block_size != block_size:
                raise ValueError(
                    f"shared pool block_size {pool.block_size} != engine "
                    f"block_size {block_size}")
            if _canonical(pool.device) != _canonical(self.device):
                raise ValueError(f"shared pool lives on {pool.device}, this "
                                 f"engine on {self.device}")
            if pool.dtype != dtype:
                raise ValueError(f"shared pool dtype {pool.dtype} != engine "
                                 f"dtype {dtype}")
            self.cache = PagedKVCache.from_pool(
                pool, max_seqs, max_blocks_per_seq, quota=kv_quota)
        else:
            kv_spec = None
            if mesh is not None:
                from repro_torch.launch.sharding import pool_pspecs
                kv_spec = pool_pspecs(cfg, shard_plan)
            self.cache = PagedKVCache.from_pool(
                BlockPool(cfg, num_blocks, block_size, dtype, self.device,
                          mesh=mesh, kv_spec=kv_spec,
                          rules=shard_plan.rules if shard_plan else None),
                max_seqs, max_blocks_per_seq)
        self.max_seqs = max_seqs
        self.greedy = greedy
        self.seed = seed
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.waiting: list[EngineRequest] = []
        self.active: dict[int, EngineRequest] = {}    # slot -> request
        self.admitting = True
        self.steps = 0
        self.tokens_out = 0
        # tokens that went through a prefill forward (one-shot or chunked),
        # re-prefilled contexts included; a page import adds none
        self.prefill_tokens = 0
        # global decode-step counter: step t samples from
        # step_generator(seed, t) in every horizon
        self._sample_step = 0
        # one increment per decode device->host sync (one per horizon)
        self.decode_syncs = 0
        # dispatched horizon histogram {h: count} + the last dispatched h
        self.horizon_counts: dict[int, int] = {}
        self.last_horizon = 0
        # chunked-prefill round-robin rotation pointer
        self._chunk_rr = 0
        # SLO shedding: rids rejected for a blown TTFT or TPOT budget
        self.shed_rids: list[int] = []
        # the cluster's traffic through this replica: sequences its
        # rebalancer moved on and off, lower-priority ones preempted here,
        # and first-token-ready contexts handed between roles
        self.rebalanced_in = 0
        self.rebalanced_out = 0
        self.preempted = 0
        self.role = role
        self.handoff_in = 0
        self.handoff_out = 0
        # one time source for deadlines, pacing and trace events
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self.trace_id = trace_id
        self.clock = clock if clock is not None else self.telemetry.clock
        # chaos injection at admission (see the module docstring)
        self.fault_hook = None
        # prefix reuse resumes prefill mid-prompt through the chunk forward,
        # which SSM models do not have, and pages carry no SSM state: the
        # cache is attention-only.  Engines on one pool share its index.
        self.prefix_cache = None
        if prefix_cache and cfg.has_attn and not cfg.has_ssm:
            self.prefix_cache = (self.cache.pool.prefix_cache
                                 or PrefixCache(self.cache.pool))
            if self.telemetry.enabled:
                # the pool's sink: evict/restore events carry replica -1
                self.prefix_cache.telemetry = self.telemetry
        # (rid, cached tokens, context tokens) per admission
        self.prefix_events: list[tuple[int, int, int]] = []
        # the compiled steps: the chunk forward of an unsharded engine (in
        # both modes the same forward over the paged pool), and its paged
        # decode horizon when greedy
        self._steps = StepGraphs(self.device)
        self._chunk_graphs = graphs and mesh is None
        self._decode_graphs = (self._chunk_graphs and greedy
                               and decode_mode == "paged")

    @property
    def graph_captures(self) -> int:
        """Compiled-step entries built: on the card each is a capture."""
        return self._steps.captures

    @property
    def graph_replays(self) -> int:
        """Compiled-step calls served by an existing entry."""
        return self._steps.replays

    @property
    def capture_s(self) -> float:
        """Seconds spent capturing (the first calls' eager runs not
        included)."""
        return self._steps.capture_s

    def _graph_reads(self) -> list[torch.Tensor]:
        """Every tensor a compiled step reads besides its inputs: a new
        address drops the graphs."""
        c = self.cache
        return ([c.block_table_dev, c.seq_lens_dev]
                + [t for t in (c.k, c.v, c.ssm, c.conv) if t is not None]
                + leaves(self.params))

    # -- submission ------------------------------------------------------------

    @property
    def max_context(self) -> int:
        """Tokens one sequence's block table can address."""
        return self.cache.max_blocks_per_seq * self.cache.block_size

    def _capacity_blocks(self) -> int:
        """Blocks one sequence may ever hold on this replica."""
        cap = min(self.cache.max_blocks_per_seq, self.cache.num_blocks)
        if self.cache.quota is not None:
            cap = min(cap, self.cache.quota)
        return cap

    def fits(self, ctx_len: int, new_tokens: int) -> bool:
        """Can this replica ever serve a request of this size?"""
        if new_tokens < 1:
            return False
        need = ctx_len + new_tokens - 1
        bs = self.cache.block_size
        return (need + bs - 1) // bs <= self._capacity_blocks()

    def _validate(self, ctx_len: int, new_tokens: int, rid: int) -> None:
        if new_tokens < 1:
            raise ValueError(f"request {rid}: max_new_tokens must be >= 1")
        # the final generated token is returned but never written to a page,
        # so lifetime cache footprint is ctx + new - 1 positions
        if not self.fits(ctx_len, new_tokens):
            need = ctx_len + new_tokens - 1
            raise ValueError(
                f"request {rid}: context {ctx_len} + {new_tokens} new tokens "
                f"needs {need} cache positions but this replica's "
                f"per-sequence block capacity is "
                f"{self._capacity_blocks()} x {self.cache.block_size} tokens")

    def submit(self, rid: int, prompt: np.ndarray, max_new_tokens: int,
               ttft_deadline: float | None = None,
               tpot_deadline: float | None = None,
               type_id: int = -1, priority: int = 0) -> None:
        """Queue a request.  ``ttft_deadline`` (absolute, engine clock)
        sheds it if it is still waiting when the deadline passes;
        ``tpot_deadline`` (seconds a token) sheds it mid-flight when its
        pace since the first token exceeds the budget.  ``type_id`` only
        labels the telemetry event; ``priority`` (higher first) orders
        admission and marks preemption victims for the cluster."""
        prompt = np.asarray(prompt, np.int32)
        self._validate(len(prompt), max_new_tokens, rid)
        req = EngineRequest(rid, prompt, max_new_tokens,
                            deadline=ttft_deadline,
                            tpot_budget=tpot_deadline, priority=priority,
                            t_submit=self.clock())
        tm = self.telemetry
        if tm.enabled:
            tm.emit("submit", rid=rid, replica=self.trace_id,
                    type_id=type_id, prompt_len=len(prompt),
                    max_new=max_new_tokens)
        self.waiting.append(req)

    def _free_slots(self) -> list[int]:
        return [s for s in range(self.max_seqs) if s not in self.active]

    # -- replica lifecycle -------------------------------------------------------

    def pause_admission(self) -> None:
        """Stop moving waiting requests into slots (switch in progress)."""
        self.admitting = False

    def resume_admission(self) -> None:
        self.admitting = True

    def drain(self, max_steps: int | None = None) -> list[EngineRequest]:
        """Run admission-free steps until the active set empties or
        ``max_steps`` have run; what is still running is left for
        ``export_inflight``.  Admission stays paused on return."""
        self.pause_admission()
        finished: list[EngineRequest] = []
        steps = 0
        while self.active and (max_steps is None or steps < max_steps):
            finished.extend(self.step())
            steps += 1
        return finished

    def export_inflight(self, release: bool = True
                        ) -> list[InflightSnapshot]:
        """Snapshot and evict every active and queued request.

        ``release=True``: token state only; the pages go back to the pool
        and a destination re-prefills ``prompt + generated``
        (``import_inflight``).  ``release=False``: a sequence past its
        prefill keeps its pages and a copy of its SSM rows in the snapshot,
        for ``import_by_pages``; the caller must adopt or release them.
        """
        snaps = [self._snapshot_slot(slot, self.active.pop(slot), release)
                 for slot in sorted(self.active)]
        snaps += [_token_snapshot(r) for r in self.waiting]
        self.waiting = []
        return snaps

    def _snapshot_slot(self, slot: int, r: EngineRequest,
                       release: bool) -> InflightSnapshot:
        """Snapshot one evicted active request (slot already popped): token
        state only when ``release`` or mid-prefill (its pages go back to
        the pool), else a snapshot that owns the slot's disowned pages."""
        if release or r.prefilling:
            # a mid-chunk prefix is not resumable state: drop the pages
            self.cache.release_slot(slot)
            return _token_snapshot(r)
        # the slot's next occupant overwrites these rows in place: the
        # snapshot keeps copies, in the logical layout-free form
        ssm = conv = None
        if self.cache.ssm is not None:
            ssm, conv = self.cache.slot_rows(slot)
        n_shared = self.cache.seq_shared.get(slot, 0)
        blocks, seq_len = self.cache.disown_slot(slot)
        return _token_snapshot(r, blocks=blocks, seq_len=seq_len,
                               n_shared=n_shared, pool=self.cache.pool,
                               ssm=ssm, conv=conv)

    def export_request(self, rid: int, release: bool = False
                       ) -> InflightSnapshot | None:
        """Evict one request, leaving every other request and the
        admission gate as they are; None if ``rid`` is not here."""
        for slot, r in list(self.active.items()):
            if r.rid == rid:
                del self.active[slot]
                return self._snapshot_slot(slot, r, release)
        for i, r in enumerate(self.waiting):
            if r.rid == rid:
                return _token_snapshot(self.waiting.pop(i))
        return None

    def import_by_pages(self, snaps: list[InflightSnapshot]
                        ) -> list[InflightSnapshot]:
        """Adopt migrated sequences from their pages: by handoff when the
        snapshot's pool is this engine's (only the ownership moves), else
        by copying the pages (``copy_blocks``), re-laying them out when
        the page size differs (``relayout_blocks``), or resharding them
        when the pools' placement or KV-head counts differ
        (``reshard_blocks``), and releasing the source's.  Adopted requests join ``active`` mid-generation.

        Returns the snapshots that could not be adopted (no pages, no free
        slot, no room); they still hold their pages, and the caller falls
        back to ``import_inflight`` for them.
        """
        rejected: list[InflightSnapshot] = []
        for s in snaps:
            if s.blocks is None or s.pool is None or not s.generated:
                rejected.append(s)
                continue
            ctx = len(s.prompt) + len(s.generated)
            remaining = s.max_new_tokens - len(s.generated)
            if remaining < 1:
                raise ValueError(f"request {s.rid}: nothing left to generate")
            free = self._free_slots()
            # lifetime positions: resident prefix + tokens still to cache
            total = ctx + remaining - 1
            if not free or not self.fits(ctx, remaining):
                rejected.append(s)
                continue
            cache = self.cache
            if s.pool is cache.pool:
                if not cache.can_adopt(len(s.blocks), total, s.n_shared):
                    rejected.append(s)
                    continue
                slot = free[0]
                cache.adopt_slot(slot, s.blocks, s.seq_len,
                                 total_tokens=total, n_shared=s.n_shared)
            else:
                if not cache.can_admit(s.seq_len, total_tokens=total):
                    rejected.append(s)
                    continue
                slot = free[0]
                cache.admit(slot, s.seq_len, total_tokens=total)
                dst_blocks = cache.seq_blocks[slot]
                same_place = s.pool.placement == cache.pool.placement
                same_heads = (s.pool.cfg.n_kv_heads
                              == cache.pool.cfg.n_kv_heads)
                if s.pool.k is None:
                    pass      # attention-free: the state is the SSM rows
                elif (same_place and same_heads
                        and s.pool.block_size == cache.block_size):
                    copy_blocks(s.pool, cache.pool, s.blocks, dst_blocks)
                elif same_place and same_heads:
                    relayout_blocks(s.pool, cache.pool, s.blocks,
                                    dst_blocks, s.seq_len)
                else:
                    # pools on different meshes / head shardings / padded
                    # head counts: dense gather, the hop, head fix and a
                    # re-chunked scatter
                    reshard_blocks(s.pool, cache.pool, s.blocks,
                                   dst_blocks, s.seq_len)
                s.pool.allocator.release(s.blocks)
            if s.ssm is not None:
                cache.set_slot_rows(slot, s.ssm, s.conv)
            r = EngineRequest(s.rid, np.asarray(s.prompt, np.int32),
                              s.max_new_tokens, slot=slot,
                              generated=list(s.generated),
                              tpot_budget=s.tpot, priority=s.priority)
            r.prefill_pos = len(r.prefill_tokens)   # the prefix is in pages
            # the pace clock restarts here: the move's stall is the
            # switch's, not this request's TPOT
            r.t_first = self.clock()
            self.active[slot] = r
            # this engine owns the pages now: a later release of the
            # snapshot must not free them again
            s.blocks = s.pool = s.ssm = s.conv = None
        return rejected

    def import_inflight(self, snaps: list[InflightSnapshot]) -> None:
        """Resume migrated requests by re-prefilling ``prompt +
        generated``; the prefill's last logits give the token a decode step
        on the source would have given next (greedy).  A request that never
        prefilled is submitted anew."""
        for s in snaps:
            if not s.generated:
                self.submit(s.rid, s.prompt, s.max_new_tokens,
                            ttft_deadline=s.deadline, tpot_deadline=s.tpot,
                            priority=s.priority)
                continue
            remaining = s.max_new_tokens - len(s.generated)
            if remaining < 1:
                raise ValueError(f"request {s.rid}: nothing left to generate")
            prompt = np.asarray(s.prompt, np.int32)
            ctx = np.concatenate([prompt,
                                  np.asarray(s.generated, np.int32)])
            self._validate(len(ctx), remaining, s.rid)
            self.waiting.append(EngineRequest(
                s.rid, prompt, s.max_new_tokens,
                generated=list(s.generated), ctx=ctx,
                tpot_budget=s.tpot, priority=s.priority))

    def release_all(self) -> None:
        """Teardown: drop every request and hand every block back to the
        (shared) pool."""
        self.active = {}
        self.waiting = []
        self.cache.release_all()

    def load_stats(self) -> dict:
        """Occupancy snapshot; every key of ``LOAD_STATS_KEYS``."""
        free = self.cache.n_free_blocks
        pc = self.prefix_cache
        return {
            "waiting": len(self.waiting),
            "active": len(self.active),
            "max_seqs": self.max_seqs,
            "free_blocks": free,
            # cold cached pages are evicted on demand: free for admission
            "free_blocks_effective": free + (pc.cold_blocks() if pc else 0),
            "tokens_out": self.tokens_out,
            "steps": self.steps,
            "prefill_tokens": self.prefill_tokens,
            "prefix_hits": pc.hits if pc else 0,
            "prefix_misses": pc.misses if pc else 0,
            "prefix_hit_tokens": pc.hit_tokens if pc else 0,
            "prefix_evicted_bytes": pc.evicted_bytes if pc else 0,
            "prefix_restored_bytes": pc.restored_bytes if pc else 0,
            "shed": len(self.shed_rids),
            "decode_syncs": self.decode_syncs,
            "load": (len(self.waiting) + len(self.active)) / self.max_seqs,
            "rebalanced_in": self.rebalanced_in,
            "rebalanced_out": self.rebalanced_out,
            "preempted": self.preempted,
            "fragmentation": self._fragmentation(),
            "handoff_in": self.handoff_in,
            "handoff_out": self.handoff_out,
        }

    def _fragmentation(self) -> float:
        """1 - resident tokens / (held pages * block_size)."""
        held = sum(len(b) for b in self.cache.seq_blocks.values())
        if not held:
            return 0.0
        resident = sum(int(self.cache.seq_lens[s])
                       for s in self.cache.seq_blocks)
        return 1.0 - resident / (held * self.cache.block_size)

    def inflight_context_lens(self) -> list[int]:
        """Context length of every sequence holding live pages (a planner's
        migration-cost input); queued and mid-prefill requests move by
        requeue, not by their pages, and are left out."""
        return [len(r.prompt) + len(r.generated)
                for r in self.active.values() if not r.prefilling]

    # -- scheduling ------------------------------------------------------------

    def _shed_blown(self) -> None:
        """Drop waiting requests whose TTFT deadline has passed: prefilling
        them cannot meet it, so their capacity goes to requests that can."""
        if not any(r.deadline is not None for r in self.waiting):
            return
        now = self.clock()
        keep = []
        tm = self.telemetry
        for r in self.waiting:
            if r.deadline is not None and now > r.deadline:
                self.shed_rids.append(r.rid)
                if tm.enabled:
                    tm.emit("shed", rid=r.rid, replica=self.trace_id,
                            reason="ttft")
                    tm.metrics.count("shed_ttft")
            else:
                keep.append(r)
        self.waiting = keep

    def _admit(self) -> list[EngineRequest]:
        """Move waiting requests into free slots while KV blocks remain."""
        admitted = []
        if not self.admitting:
            return admitted
        if self.fault_hook is not None:
            self.fault_hook("admit")
        self._shed_blown()
        # priority first; the stable sort keeps FIFO within a priority, and
        # the all-default queue is left as it is
        if any(r.priority for r in self.waiting):
            self.waiting.sort(key=lambda r: -r.priority)
        free = self._free_slots()
        while self.waiting and free:
            req = self.waiting[0]
            ctx = len(req.prefill_tokens)
            # reserve the lifetime footprint (prompt + decode growth)
            total = ctx + (req.max_new_tokens - len(req.generated)) - 1
            cached, shared, cow = 0, (), None
            if self.prefix_cache is not None and req.prefill_pos == 0:
                # attach (which restores host pages) comes before the
                # capacity check: a failed restore shortens the match.  The
                # cap at ctx - 1 leaves the forward one token, whose logits
                # give the first generated token.
                m = self.prefix_cache.match(req.prefill_tokens, ctx - 1)
                cached, shared, cow = self.prefix_cache.attach(m)
            if not self.cache.can_admit(ctx, total, shared):
                break
            self.waiting.pop(0)
            req.slot = free.pop(0)
            self.cache.admit(req.slot, ctx, total, shared, cow)
            if cached:
                req.prefill_pos = cached   # prefill starts past the prefix
            if self.prefix_cache is not None:
                self.prefix_events.append((req.rid, cached, ctx))
            tm = self.telemetry
            if tm.enabled:
                now = self.clock()
                delay = (now - req.t_submit
                         if req.t_submit is not None else 0.0)
                tm.emit("admit", rid=req.rid, replica=self.trace_id,
                        reserved_bytes=(self.cache.seq_reserved.get(
                            req.slot, 0) * self.cache.pool.page_nbytes),
                        cached_tokens=cached, queue_delay_s=delay)
                tm.metrics.observe("queue_delay_s", delay)
                if cached:
                    tm.emit("prefix_hit", rid=req.rid,
                            replica=self.trace_id, tokens=cached,
                            pages=len(shared) + (1 if cow is not None
                                                 else 0))
            self.active[req.slot] = req
            admitted.append(req)
        return admitted

    def _publish(self, slot: int, r: EngineRequest) -> None:
        """Hand the sequence's full resident pages to the prefix index, so
        later prompts with the same leading tokens attach them.  Called when
        the context is all in pages and again at retirement (decode has
        extended the stream by then), always before the slot's release."""
        if self.prefix_cache is None:
            return
        blocks = self.cache.seq_blocks.get(slot)
        if not blocks:
            return
        resident = int(self.cache.seq_lens[slot])
        stream = np.concatenate([np.asarray(r.prompt, np.int32),
                                 np.asarray(r.generated, np.int32)])
        self.prefix_cache.publish(stream[:resident], blocks)

    def _note_first_token(self, r: EngineRequest, now: float) -> None:
        """Telemetry: a request's first token ever.  Callers check that
        ``r.generated`` was empty before the append: a re-prefilled request
        had its first token on its origin replica."""
        tm = self.telemetry
        if not tm.enabled:
            return
        ttft = now - r.t_submit if r.t_submit is not None else 0.0
        tm.emit("first_token", rid=r.rid, replica=self.trace_id,
                ttft_s=ttft)
        tm.metrics.observe("ttft_s", ttft)

    def _run_prefill(self, reqs: list[EngineRequest]) -> None:
        # group by prompt length: same-length batches need no padding
        by_len: dict[int, list[EngineRequest]] = {}
        for r in reqs:
            by_len.setdefault(len(r.prefill_tokens), []).append(r)
        for pl, group in by_len.items():
            toks = torch.from_numpy(
                np.stack([r.prefill_tokens for r in group])).to(self.device)
            logits, cache = self._prefill(self.params, self.cfg, toks)
            for i, r in enumerate(group):
                if self.cfg.has_attn:
                    self.cache.write_prefill(r.slot, cache.k[:, i],
                                             cache.v[:, i])
                if self.cfg.has_ssm:
                    self.cache.ssm[:, r.slot] = cache.ssm[:, i]
                    self.cache.conv[:, r.slot] = cache.conv[:, i]
            first = self._pick(logits)           # one sync per group
            self.prefill_tokens += pl * len(group)
            t_first = self.clock()
            for i, r in enumerate(group):
                r.t_first = t_first
                r.prefill_pos = pl
                fresh = not r.generated
                r.generated.append(int(first[i]))
                self.tokens_out += 1
                if fresh:
                    self._note_first_token(r, t_first)
                self._publish(r.slot, r)

    def _chunk_forward(self, r: EngineRequest, start: int, n_valid: int,
                       bucket: int) -> torch.Tensor:
        """One chunk forward of ``r``'s context, positions ``start +
        [0, n_valid)``, run at ``bucket`` tokens (the tail writes to the
        trash page).  Returns the logits at its last real position."""
        buf = np.zeros((1, bucket), np.int32)
        buf[0, :n_valid] = r.prefill_tokens[start:start + n_valid]
        bs = self.cache.block_size
        need = (start + n_valid + bs - 1) // bs
        n_pages = _pow2_bucket(need, self.cache.max_blocks_per_seq)
        self.prefill_tokens += n_valid
        tokens = torch.from_numpy(buf).to(self.device)
        table = self.cache.block_table_dev[r.slot:r.slot + 1, :n_pages]
        if not self._chunk_graphs:
            return self._prefill_chunk(
                self.params, self.cfg, tokens, self.cache.k, self.cache.v,
                table, start, n_valid, self.cache.pool.trash_page)
        pos = torch.tensor([start, n_valid], dtype=torch.int32).to(
            self.device)
        return self._steps.run(
            ("chunk", bucket, n_pages),
            dict(tokens=tokens, table=table, start=pos[0], n_valid=pos[1]),
            self._chunk_step, self._graph_reads())

    def _chunk_step(self, tokens, table, start, n_valid) -> torch.Tensor:
        """The chunk forward on device scalars ``start``/``n_valid``."""
        return self._prefill_chunk(
            self.params, self.cfg, tokens, self.cache.k, self.cache.v, table,
            start, n_valid, self.cache.pool.trash_page)

    def _first_token(self, r: EngineRequest, logits: torch.Tensor) -> None:
        """A finished prefill's logits give the request its next token;
        its context is now all in pages, which it publishes."""
        first = self._pick(logits)
        r.t_first = self.clock()
        fresh = not r.generated
        r.generated.append(int(first[0]))
        self.tokens_out += 1
        if fresh:
            self._note_first_token(r, r.t_first)
        self._publish(r.slot, r)

    def _resume_prefill(self, reqs: list[EngineRequest]) -> None:
        """Prefill the uncached suffix of each prefix-cache hit, one chunk
        forward a request at a power-of-two bucket of its length.  Cached
        tokens cost nothing; writes start at ``prefill_pos``, whose page is
        private (fresh or copied), so shared pages stay as they are."""
        for r in reqs:
            start = r.prefill_pos
            n_valid = len(r.prefill_tokens) - start
            logits = self._chunk_forward(r, start, n_valid,
                                         1 << (n_valid - 1).bit_length())
            r.prefill_pos = start + n_valid
            self._first_token(r, logits)

    def _advance_chunked(self) -> None:
        """Spread this step's chunk-token budget over all mid-prefill
        sequences, round-robin from a start slot that rotates every step.

        Each slot's share is the budget left over the slots still to serve
        this step, floored at a quarter of the budget (so at most four
        sequences advance per step and no chunk forward is tiny); a short
        remainder leaves its unused share to the slots behind it.  A chunk
        runs at a power-of-two bucket of its length; the final chunk's
        logits give the request its first token.
        """
        slots = sorted(s for s, r in self.active.items() if r.prefilling)
        if not slots:
            return
        rot = self._chunk_rr % len(slots)
        self._chunk_rr += 1
        order = slots[rot:] + slots[:rot]
        chunk = self.prefill_chunk_tokens
        budget = chunk
        floor = max(1, chunk // 4)
        for idx, slot in enumerate(order):
            if budget <= 0:
                break
            share = max(floor, budget // (len(order) - idx))
            r = self.active[slot]
            start = r.prefill_pos
            n_valid = min(share, budget, len(r.prefill_tokens) - start)
            logits = self._chunk_forward(r, start, n_valid,
                                         _pow2_bucket(n_valid, chunk))
            budget -= n_valid
            r.prefill_pos = start + n_valid
            if self.telemetry.enabled:
                self.telemetry.emit("prefill_chunk", rid=r.rid,
                                    replica=self.trace_id, tokens=n_valid,
                                    pos=r.prefill_pos)
            if not r.prefilling:              # the final chunk: token 1
                self._first_token(r, logits)

    def _pick(self, logits: torch.Tensor) -> np.ndarray:
        if self.greedy:
            return sample(logits, self.cfg).cpu().numpy()
        return sample(logits, self.cfg, self._gen,
                      temperature=1.0).cpu().numpy()

    # -- decode ------------------------------------------------------------------

    def _safe_horizon(self, slots: list[int], event: bool) -> int:
        """How many decode steps the next dispatch may take:
        ``min(decode_horizon, min remaining max_new_tokens)``, 1 on a step
        with a scheduling event (an admission or a chunk in flight),
        floored to a power of two."""
        H = self.decode_horizon
        if H <= 1 or event:
            return 1
        rem = min(self.active[s].max_new_tokens - len(self.active[s].generated)
                  for s in slots)
        H = min(H, rem)
        return _pow2_floor(H) if H > 1 else 1

    def _dispatch_decode(self, slots: list[int], horizon: int
                         ) -> PendingDecode:
        """Fire the decode loop over the given slots; no host sync.

        Pre-extends page capacity for the whole horizon and advances the
        host ``seq_lens``; the device mirror advances with the loop.
        """
        slots = sorted(slots)
        updates = []
        for s in slots:
            upd = self.cache.extend_for(s, horizon)
            if upd is not None:
                updates.append(upd)
        self.cache.apply_table_updates(updates)   # one scatter for the batch
        B = len(slots)
        bucket = _pow2_bucket(B, self.max_seqs)
        trash = self.cache.trash_slot
        pad = bucket - B
        dev = self.device
        slot_t = torch.tensor(slots + [trash] * pad, dtype=torch.long,
                              device=dev)
        last = torch.tensor([self.active[s].generated[-1] for s in slots]
                            + [0] * pad, dtype=torch.int32, device=dev)
        bs = self.cache.block_size
        need = (int(self.cache.seq_lens[slots].max()) + bs - 1) // bs
        n_pages = _pow2_bucket(need, self.cache.max_blocks_per_seq)
        step0 = self._sample_step
        self._sample_step += horizon
        self.horizon_counts[horizon] = self.horizon_counts.get(horizon, 0) + 1
        self.last_horizon = horizon
        if self.telemetry.enabled:
            self.telemetry.emit("dispatch", replica=self.trace_id, n=B,
                                h=horizon)

        def step(slot_t, last):
            return self._decode_step(slot_t, last, n_pages, horizon, step0)

        if self._decode_graphs:
            # the graph's output is copied out: a later replay cannot
            # overwrite a horizon that has not been synced
            toks = self._steps.run(("decode", bucket, n_pages, horizon),
                                   dict(slot_t=slot_t, last=last), step,
                                   self._graph_reads())
        else:
            toks = step(slot_t, last)
        return PendingDecode(slots, toks, horizon)

    def _decode_step(self, slot_t, last, n_pages: int, horizon: int,
                     step0: int) -> torch.Tensor:
        """The device half of a decode horizon over the slots ``slot_t``
        (trash-padded) fed ``last``: gather their table, lens and SSM rows,
        run the loop, scatter lens and rows back.  Returns [B, horizon]."""
        cache = self.cache
        has_ssm = cache.ssm is not None
        state = PagedDecodeState(
            k=cache.k, v=cache.v,
            block_table=cache.block_table_dev[slot_t, :n_pages].contiguous(),
            lens=cache.seq_lens_dev[slot_t],
            # gathers copy the batch's rows; the loop updates the copies
            ssm=cache.ssm[:, slot_t] if has_ssm else None,
            conv=cache.conv[:, slot_t] if has_ssm else None)
        toks, state = self._decode_loop(
            self.params, self.cfg, last, state, horizon,
            temperature=0.0 if self.greedy else 1.0, seed=self.seed,
            step0=step0)
        cache.seq_lens_dev[slot_t] = state.lens
        # padded rows advanced the trash slot's lens; pin it back to 0
        cache.seq_lens_dev[cache.trash_slot].zero_()
        if has_ssm:
            # padded rows land on the trash row, which no slot reads
            cache.ssm[:, slot_t] = state.ssm
            cache.conv[:, slot_t] = state.conv
        return toks

    def _finish_decode(self, pending: PendingDecode) -> None:
        """Sync a dispatched horizon: ONE [B, H] device->host transfer."""
        toks = pending.tokens.cpu().numpy()
        self.decode_syncs += 1
        for i, s in enumerate(pending.slots):
            self.active[s].generated.extend(
                int(t) for t in toks[i, :pending.horizon])
            self.tokens_out += pending.horizon
        if self.telemetry.enabled:
            self.telemetry.emit("sync", replica=self.trace_id,
                                n=len(pending.slots),
                                tokens=len(pending.slots) * pending.horizon)

    def _run_decode_dense(self, slots: list[int]) -> None:
        """The dense-gather decode (the JAX package's A/B baseline): one
        step over the slots through a dense copy of their K/V, synced at
        once."""
        slots = np.array(sorted(slots), np.int64)
        cache = self.cache
        dev = self.device
        lens = cache.seq_lens[slots].copy()
        slot_t = torch.from_numpy(slots).to(dev)
        pos = torch.from_numpy(lens).to(dev)
        k = v = None
        if self.cfg.has_attn:
            k, v, _ = cache.gather_dense(slots, int(lens.max()) + 1)
        has_ssm = cache.ssm is not None
        dc = DecodeCache(
            k=k, v=v,
            # gathers copy the batch's rows; the step updates the copies
            ssm=cache.ssm[:, slot_t] if has_ssm else None,
            conv=cache.conv[:, slot_t] if has_ssm else None, pos=pos)
        last = torch.tensor([self.active[int(s)].generated[-1]
                             for s in slots], dtype=torch.int32, device=dev)
        logits, _ = decode_step(self.params, self.cfg, last, dc)
        toks = self._pick(logits)
        # persist the new K/V token and SSM rows
        updates = [cache.extend_for(int(s), 1) for s in slots]
        cache.apply_table_updates([u for u in updates if u is not None])
        if self.cfg.has_attn:
            rows = torch.arange(len(slots), device=dev)
            cache.write_token(slots, dc.k[:, rows, pos.long()],
                              dc.v[:, rows, pos.long()], lens)
        if has_ssm:
            cache.ssm[:, slot_t] = dc.ssm
            cache.conv[:, slot_t] = dc.conv
        for i, s in enumerate(slots):
            self.active[int(s)].generated.append(int(toks[i]))
            self.tokens_out += 1

    def _retire(self) -> list[EngineRequest]:
        done = []
        tm = self.telemetry
        for s in list(self.active):
            r = self.active[s]
            if len(r.generated) >= r.max_new_tokens:
                r.done = True
                self._publish(s, r)   # decode pages join the prefix index
                self.cache.release_slot(s)
                del self.active[s]
                done.append(r)
                if tm.enabled:
                    now = self.clock()
                    tm.emit("retire", rid=r.rid, replica=self.trace_id,
                            tokens=len(r.generated))
                    if r.t_first is not None and len(r.generated) > 1:
                        tm.metrics.observe(
                            "tpot_s", (now - r.t_first)
                            / (len(r.generated) - 1))
        return done

    def _shed_slow(self) -> None:
        """Release active requests whose average pace since their first
        token blew their TPOT budget; their slot and pages go to requests
        that can still meet theirs.  Runs after retirement, so a request
        that just produced its last token completes."""
        if not any(r.tpot_budget is not None for r in self.active.values()):
            return
        now = self.clock()
        for s in list(self.active):
            r = self.active[s]
            if (r.tpot_budget is None or r.t_first is None
                    or len(r.generated) < 2):
                continue
            if (now - r.t_first) / (len(r.generated) - 1) > r.tpot_budget:
                self.shed_rids.append(r.rid)
                if self.telemetry.enabled:
                    self.telemetry.emit("shed", rid=r.rid,
                                        replica=self.trace_id,
                                        reason="tpot")
                    self.telemetry.metrics.count("shed_tpot")
                self._publish(s, r)   # evicted work still warms the cache
                self.cache.release_slot(s)
                del self.active[s]

    # -- main loop ---------------------------------------------------------------

    def step_async(self) -> PendingDecode | None:
        """The host half of one scheduler iteration: admission, prefill, the
        chunked-prefill advance and the decode dispatch, but not the paged
        decode's sync.  Returns the pending decode (None when nothing
        decoded, or when the dense mode already synced) for
        ``finish_step``.

        Sequences already active decode on a step that admits new prompts
        (newly admitted requests get their first token from prefill).  With
        ``prefill_chunk_tokens`` set, prompts longer than it advance chunk
        by chunk; while any does, the horizon collapses to 1."""
        self.steps += 1
        decode_slots = [s for s, r in self.active.items() if not r.prefilling]
        admitted = self._admit()
        chunk = self.prefill_chunk_tokens
        # a prefix-cache hit (prefill_pos > 0) resumes mid-prompt instead of
        # prefilling its whole prompt; a chunking engine resumes it through
        # the chunk budget, which starts each chunk at prefill_pos
        oneshot = [r for r in admitted
                   if (chunk is None or len(r.prefill_tokens) <= chunk)
                   and r.prefill_pos == 0]
        if oneshot:
            self._run_prefill(oneshot)
        if chunk is None:
            resumed = [r for r in admitted
                       if 0 < r.prefill_pos < len(r.prefill_tokens)]
            if resumed:
                self._resume_prefill(resumed)
        # taken before the advance: a prefill that completes this step is
        # still an event (its sequence joins decode next step)
        chunking = any(r.prefilling for r in self.active.values())
        if chunk is not None:
            self._advance_chunked()
        if decode_slots:
            if self.decode_mode == "paged":
                h = self._safe_horizon(decode_slots,
                                       bool(admitted) or chunking)
                return self._dispatch_decode(decode_slots, h)
            self._run_decode_dense(decode_slots)
        return None

    def finish_step(self, pending: PendingDecode | None
                    ) -> list[EngineRequest]:
        """Sync a dispatched step, retire finished requests and shed
        TPOT-blown ones."""
        if pending is not None:
            self._finish_decode(pending)
        done = self._retire()
        self._shed_slow()
        return done

    def step(self) -> list[EngineRequest]:
        """One synchronous scheduler iteration; returns requests finished
        this step."""
        return self.finish_step(self.step_async())

    def run_to_completion(self, max_steps: int = 100_000
                          ) -> list[EngineRequest]:
        finished = []
        while (self.waiting or self.active) and self.steps < max_steps:
            finished.extend(self.step())
        return finished
