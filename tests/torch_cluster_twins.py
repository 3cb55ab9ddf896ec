"""Helpers of the cluster parity tests (``tests/test_torch_cluster*.py``,
``tests/test_torch_telemetry.py``): each package's cluster entry points
bound to one smoke config and its weights, and the runtime's state as
plain values, so that a JAX ``ClusterRuntime`` and the port's can be held
against each other field by field.  The scenarios themselves are
``chip_smoke.py``'s (``bench_*_twin``, ``switch_crash_twin``), which phase 4
runs on the card."""
import dataclasses
import functools
import importlib.util
import math
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np

import repro.models as jm
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.types import Deployment as JaxDeployment
from repro.core.types import ReplicaConfig as JaxReplicaConfig
from repro.serving.cluster import ClusterRuntime as JaxCluster
from repro.serving.cluster import RebalanceConfig as JaxRebalance
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.faults import FaultPlan as JaxFaultPlan
from repro.serving.faults import FaultSpec as JaxFaultSpec
from repro.serving.router import FlowRouter as JaxFlowRouter
from repro.serving.telemetry import Telemetry as JaxTelemetry
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.serving.engine import ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def chip_smoke():
    """``chip_smoke.py``, whose cluster scenarios the parity tests share."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def weights(arch):
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def package(name, arch="yi-9b"):
    """One package's cluster entry points (``chip_smoke.cluster_package``'s
    fields), its smoke config and weights (``cfg``, ``params``) and an
    engine factory, fp32 on the CPU."""
    jcfg, jp, cfg, tp = weights(arch)
    if name == "jax":
        pkg = types.SimpleNamespace(
            ClusterRuntime=JaxCluster, RebalanceConfig=JaxRebalance,
            FaultPlan=JaxFaultPlan, FaultSpec=JaxFaultSpec,
            FlowRouter=JaxFlowRouter, Telemetry=JaxTelemetry,
            ReplicaConfig=JaxReplicaConfig, Deployment=JaxDeployment,
            kw=dict(dtype=jnp.float32))
        pkg.cfg, pkg.params = jcfg, jp
        pkg.engine = lambda **kw: JaxEngine(jcfg, jp, **kw)
    else:
        pkg = chip_smoke().cluster_package("cpu")
        pkg.cfg, pkg.params = cfg, tp
        pkg.engine = lambda **kw: ServingEngine(cfg, tp, device="cpu", **kw)
    pkg.name = name
    return pkg


def runtime(pkg, **kw):
    return pkg.ClusterRuntime(pkg.cfg, pkg.params, **pkg.kw, **kw)


def plan(pkg, rcs, fractions):
    """A span plan of ``rcs`` given as (tp, pp, role) tuples."""
    return chip_smoke().span_plan(
        pkg, [pkg.ReplicaConfig(*rc) for rc in rcs], fractions)


def plain(x):
    """Numpy values, dataclasses (reports, replica configs) and NaN as
    plain comparable values."""
    if type(x).__name__ == "ReplicaConfig":
        return (x.tp, x.pp, x.role)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return "nan" if math.isnan(x) else float(x)
    return x


def cluster_state(rt) -> dict:
    """Everything a run leaves that the two packages must agree on: the
    streams, reports, per-replica ``load_stats``, prefill tokens, shed rids,
    the request log, the pool's free list and reservation, and the failure
    and rebalancer bookkeeping."""
    pool = rt.pool
    return plain({
        "tokens": {r: rt.results[r].generated for r in sorted(rt.results)},
        "switch_reports": rt.switch_reports,
        "load_stats": rt.load_stats(),
        "prefill_tokens": rt.total_prefill_tokens,
        "shed_rids": rt.shed_rids,
        "all_shed_rids": rt.all_shed_rids,
        "request_log": {r: (lg.prompt, lg.max_new_tokens, lg.emitted,
                            lg.ttft_deadline, lg.tpot_deadline, lg.priority)
                        for r, lg in sorted(rt.request_log.items())},
        "free": list(pool.allocator.free),
        "refs": pool.allocator.refs,
        "reserved": pool.reserved,
        "dead": (rt.dead_replicas, rt.repaired_replicas, rt.lost_chips),
        "owner": dict(sorted(rt.rid_owner.items())),
        "evicted": dict(sorted(rt._evicted.items())),
        "rcs": [h.rc for h in rt.replicas],
        "pending": rt.pending,
    })


def events(tm) -> list:
    """A telemetry stream as (kind, ts, rid, replica, data) tuples."""
    return [(e.kind, e.ts, e.rid, e.replica, plain(e.data))
            for e in tm.tracer.events]


class RecordingOrch:
    """A stand-in orchestrator that records every call the runtime makes
    (``observe_*``, ``on_switch_rollback``) with plain arguments."""

    def __init__(self, chips):
        self.cluster = types.SimpleNamespace(chips=chips)
        self.audit = None
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("observe_") or name == "on_switch_rollback":
            return lambda *a, **k: self.calls.append(
                (name, plain(list(a)), plain(k)))
        raise AttributeError(name)


# ``tests/test_faults.py``'s seeded chaos matrix: FaultPlan.seeded shapes
MATRIX = {
    "crash-decode": dict(crashes=1, stalls=0),
    "crash-decode-lose-pages": dict(crashes=1, stalls=0, lose_pages=True),
    "crash-during-switch": dict(crashes=0, stalls=0,
                                switch_failure="switch_migrate"),
    "build-failure": dict(crashes=0, stalls=0,
                          switch_failure="switch_build"),
    "stall": dict(crashes=0, stalls=1),
    "oom": dict(crashes=0, stalls=0, ooms=1),
    "slow": dict(crashes=0, stalls=0, slows=1),
    "hotspot": dict(crashes=0, stalls=0, hotspots=1),
}


@functools.lru_cache(maxsize=None)
def matrix_run(name, case, seed):
    """One cell of the matrix (``test_chaos_matrix_seeded``): two 1-chip
    replicas, 8 requests, 6 ticks, a switch to [2, 1] chips (the target
    of the switch faults), then to idle."""
    pkg = package(name)
    faults = pkg.FaultPlan.seeded(seed, n_replicas=2, horizon_ticks=6,
                                  **MATRIX[case])
    rt = runtime(pkg, total_chips=4, blocks_per_chip=32, seqs_per_chip=4,
                 block_size=8, drain_steps=1,
                 router=pkg.FlowRouter([[0.5], [0.5]]), faults=faults)
    rt.apply_plan(plan(pkg, [(1, 1), (1, 1)], [[0.5], [0.5]]))
    rng = np.random.RandomState(7)
    jobs = [(rng.randint(0, pkg.cfg.vocab_size, 6 + (i % 3) * 2)
             .astype(np.int32), 6 + (i % 4)) for i in range(8)]
    for rid, (p, n) in enumerate(jobs):
        rt.submit(rid, p, n)
    for _ in range(6):
        rt.step()
    switch = plain(rt.apply_plan(plan(pkg, [(2, 1), (1, 1)],
                                      [[0.6], [0.4]])))
    rt.run_until_idle()
    span = plain(rt.finish_span())
    return dict(state=cluster_state(rt), span=span, switch=switch,
                specs=[dataclasses.astuple(f) for f in faults.faults])


def check_matrix_cell(case, seed):
    """The cell's JAX and port runs agree in full, every request finished
    with a fault-free engine's stream or was shed, and the fault did what
    its kind says."""
    want, got = matrix_run("jax", case, seed), matrix_run("torch", case,
                                                          seed)
    assert got == want
    state, span, sw = got["state"], got["span"], got["switch"]
    pkg = package("torch")
    rng = np.random.RandomState(7)
    ref = pkg.engine(num_blocks=256, block_size=8, max_seqs=8)
    for rid in range(8):
        ref.submit(rid, rng.randint(0, pkg.cfg.vocab_size, 6 + (rid % 3) * 2)
                   .astype(np.int32), 6 + (rid % 4))
    expected = {r.rid: r.generated for r in ref.run_to_completion()}
    shed = set(state["all_shed_rids"])
    assert shed | set(state["tokens"]) == set(range(8))
    for rid, toks in state["tokens"].items():
        assert toks == expected[rid], rid
    assert sorted(state["free"]) == list(range(128))
    assert state["reserved"] == 0
    if case.startswith("crash-decode"):
        assert span["dead_replicas"]
        if "lose-pages" in case:
            assert span["recovery"]["handoff"] == 0
    if case in ("crash-during-switch", "build-failure"):
        assert sw["rolled_back"] and sw["failure"]
        assert state["rcs"] == [(1, 1, "mixed")] * 2
    if case == "oom":
        assert span["retries"] >= 1 and not span["dead_replicas"]
