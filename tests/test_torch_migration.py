"""KV migration in the port against the JAX package's, on the same weights
and the same seeded jobs (the cases of ``tests/test_migration.py``): a
request served part-way on one engine finishes on another by page handoff,
page copy, relayout to another page size or re-prefill (one-shot and
chunked), and once into a ``decode_mode="dense"`` destination.  fp32 on
the CPU.  In each case the two packages must agree exactly on the tokens,
the ``MigrationReport`` (field by field, ``paths`` included), the
destination's host block-table and length rows right after the import,
the engines' counters, and each pool's free list and reservation count at
the end.  Each JAX scenario runs once per module.
"""
import dataclasses
import functools
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
import repro.serving.migration as jmig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.kvcache import BlockPool as JaxPool
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.serving import migration as tmig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import BlockPool

ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _package(name, arch):
    """The engine, pool and migration entry points of one package, bound
    to the arch's smoke config and weights."""
    jcfg, jp, cfg, tp = _weights(arch)
    if name == "jax":
        return types.SimpleNamespace(
            engine=lambda **kw: JaxEngine(jcfg, jp, **kw),
            pool=lambda n, bs: JaxPool(jcfg, n, bs),
            mig=jmig, vocab=jcfg.vocab_size)
    return types.SimpleNamespace(
        engine=lambda **kw: ServingEngine(cfg, tp, device="cpu", **kw),
        pool=lambda n, bs: BlockPool(cfg, n, bs, device="cpu"),
        mig=tmig, vocab=cfg.vocab_size)


def _jobs(vocab, seed, specs):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, n).astype(np.int32), new)
            for n, new in specs]


# each case: the arch, the prompt seed, (prompt len, new tokens) per
# request, the source's steps before the export, whether the export
# releases the pages, the source's and destination's pools as (num_blocks,
# block_size) ("shared": one pool for both) and their engine options
CASES = {
    # same pool: ownership moves, nothing is recomputed
    "handoff": dict(arch="yi-9b", seed=0, jobs=((40, 6), (8, 8), (21, 5)),
                    steps=3, pools=("shared", (64, 8)),
                    src=dict(max_seqs=4, kv_quota=32),
                    dst=dict(max_seqs=4, kv_quota=32)),
    # the destination's quota cannot hold both: one re-prefills one-shot
    "rejected": dict(arch="yi-9b", seed=1, jobs=((16, 6), (16, 6)), steps=2,
                     pools=("shared", (32, 8)),
                     src=dict(max_seqs=2, kv_quota=16),
                     dst=dict(max_seqs=2, kv_quota=4,
                              max_blocks_per_seq=4)),
    "ssm-hymba": dict(arch="hymba-1.5b", seed=8, jobs=((16, 5), (9, 6)),
                      steps=2, pools=("shared", (32, 8)),
                      src=dict(max_seqs=2, kv_quota=32),
                      dst=dict(max_seqs=2, kv_quota=32)),
    "ssm-mamba2": dict(arch="mamba2-370m", seed=8, jobs=((16, 5), (9, 6)),
                       steps=2, pools=("shared", (32, 8)),
                       src=dict(max_seqs=2, kv_quota=32),
                       dst=dict(max_seqs=2, kv_quota=32)),
    "copy": dict(arch="yi-9b", seed=3, jobs=((40, 6), (12, 7)), steps=2,
                 pools=((64, 8), (64, 8)),
                 src=dict(max_seqs=2, kv_quota=64),
                 dst=dict(max_seqs=2, kv_quota=64)),
    "relayout": dict(arch="yi-9b", seed=4, jobs=((21, 6), (9, 5)), steps=2,
                     pools=((64, 8), (128, 4)),
                     src=dict(max_seqs=2, kv_quota=64),
                     dst=dict(max_seqs=2, kv_quota=128)),
    # a token-state export re-prefilled by a chunking destination
    "chunked-reprefill": dict(arch="yi-9b", seed=7, jobs=((40, 8),),
                              steps=2, release=True,
                              pools=((64, 8), (64, 8)),
                              src=dict(max_seqs=2),
                              dst=dict(max_seqs=2, prefill_chunk_tokens=8)),
    # handoff into the dense decode mode: the dense decode kernel's path
    "dense-destination": dict(arch="yi-9b", seed=9, jobs=((12, 5), (9, 6)),
                              steps=2, pools=("shared", (32, 8)),
                              src=dict(max_seqs=2, kv_quota=16),
                              dst=dict(max_seqs=2, kv_quota=16,
                                       decode_mode="dense")),
}


def _engines(pkg, case):
    """(source, destination, pools) of a case."""
    a, b = case["pools"]
    if a == "shared":
        pools = (pkg.pool(*b),)
        src_pool = dst_pool = pools[0]
    else:
        pools = (pkg.pool(*a), pkg.pool(*b))
        src_pool, dst_pool = pools
    src = pkg.engine(pool=src_pool, block_size=src_pool.block_size,
                     **case["src"])
    dst = pkg.engine(pool=dst_pool, block_size=dst_pool.block_size,
                     **case["dst"])
    return src, dst, pools


def _counters(e):
    return dict(steps=e.steps, tokens_out=e.tokens_out,
                prefill_tokens=e.prefill_tokens,
                decode_syncs=e.decode_syncs)


@functools.lru_cache(maxsize=None)
def _scenario(name, package):
    """Serve the case's jobs part-way on the source, export, migrate and
    finish on the destination; everything the two packages must agree
    on."""
    case = CASES[name]
    pkg = _package(package, case["arch"])
    src, dst, pools = _engines(pkg, case)
    for rid, (p, n) in enumerate(_jobs(pkg.vocab, case["seed"],
                                       case["jobs"])):
        src.submit(rid, p, n)
    tokens = {}
    for _ in range(case["steps"]):
        for r in src.step():
            tokens[r.rid] = list(r.generated)
    snaps = src.export_inflight(release=case.get("release", False))
    held = [None if s.blocks is None else list(s.blocks) for s in snaps]
    src.release_all()
    report = pkg.mig.migrate_batch(dst, snaps)
    after_import = dict(block_table=dst.cache.block_table.copy(),
                        seq_lens=dst.cache.seq_lens.copy(),
                        used=dst.cache.used_blocks,
                        reserved=dst.cache.reserved_blocks,
                        free_blocks=dst.cache.n_free_blocks)
    for r in dst.run_to_completion():
        tokens[r.rid] = list(r.generated)
    dst.release_all()
    return dict(tokens=tokens, held=held,
                report=dataclasses.asdict(report),
                migrated=report.migrated, after_import=after_import,
                src=_counters(src), dst=_counters(dst),
                pools=[(list(p.allocator.free), p.reserved) for p in pools])


def _uninterrupted_jobs(arch, seed, specs):
    pkg = _package("torch", arch)
    eng = pkg.engine(num_blocks=256, block_size=8, max_seqs=8)
    for rid, (p, n) in enumerate(_jobs(pkg.vocab, seed, specs)):
        eng.submit(rid, p, n)
    return {r.rid: list(r.generated) for r in eng.run_to_completion()}


def _uninterrupted(name):
    """The port's stream of the case's jobs on one engine."""
    case = CASES[name]
    return _uninterrupted_jobs(case["arch"], case["seed"], case["jobs"])


def _assert_same(got, want):
    assert got["tokens"] == want["tokens"]
    assert got["report"] == want["report"]
    assert got["migrated"] == want["migrated"]
    assert got["held"] == want["held"]
    for key in ("block_table", "seq_lens"):
        np.testing.assert_array_equal(got["after_import"][key],
                                      want["after_import"][key])
    for key in ("used", "reserved", "free_blocks"):
        assert got["after_import"][key] == want["after_import"][key], key
    assert got["src"] == want["src"]
    assert got["dst"] == want["dst"]
    assert got["pools"] == want["pools"]


def _check_case(name):
    got = _scenario(name, "torch")
    _assert_same(got, _scenario(name, "jax"))
    # and the migrated streams are the uninterrupted ones
    assert got["tokens"] == _uninterrupted(name)
    # no page leaked, no reservation left behind
    case = CASES[name]
    sizes = ([case["pools"][1][0]] if case["pools"][0] == "shared"
             else [case["pools"][0][0], case["pools"][1][0]])
    assert [(len(f), r) for f, r in got["pools"]] == [(n, 0) for n in sizes]


# the SSM cases are in test_torch_migration_ssm.py, which runs on another
# worker
@pytest.mark.parametrize("name", [n for n in CASES
                                  if not n.startswith("ssm-")])
def test_migration_matches_jax(name):
    _check_case(name)


def test_handoff_recomputes_nothing():
    got = _scenario("handoff", "torch")
    rep = got["report"]
    assert rep["handoff"] == 3 and rep["copied"] == rep["reprefilled"] == 0
    assert rep["pages_handoff"] == sum(len(b) for b in got["held"])
    assert rep["recompute_tokens"] == 0
    assert got["dst"]["prefill_tokens"] == 0


@pytest.mark.parametrize("name", ["rejected", "chunked-reprefill"])
def test_reprefill_counts_prompt_and_generated(name):
    """A re-prefilled request's prefill_tokens count is len(prompt) +
    len(generated), one-shot and chunked."""
    got = _scenario(name, "torch")
    rep = got["report"]
    assert rep["reprefilled"] >= 1 and rep["recompute_tokens"] > 0
    assert got["dst"]["prefill_tokens"] == rep["recompute_tokens"]
    assert rep["recompute_tokens"] == sum(
        n for path, n in rep["paths"].values() if path == "reprefill")


@pytest.mark.parametrize("name", ["copy", "relayout"])
def test_copy_and_relayout_recompute_nothing(name):
    got = _scenario(name, "torch")
    rep = got["report"]
    assert rep["copied"] == 2 and rep["handoff"] == 0
    assert rep["pages_copied"] == sum(len(b) for b in got["held"])
    assert got["dst"]["prefill_tokens"] == 0


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_release_snapshot_pages_is_idempotent(package):
    pkg = _package(package, "yi-9b")
    pool = pkg.pool(32, 8)
    eng = pkg.engine(block_size=8, max_seqs=2, pool=pool, kv_quota=32)
    rng = np.random.RandomState(2)
    eng.submit(0, rng.randint(0, pkg.vocab, 16).astype(np.int32), 6)
    eng.step()
    (snap,) = eng.export_inflight(release=False)
    assert snap.blocks and len(pool.allocator.free) == 30
    pkg.mig.release_snapshot_pages(snap)
    pkg.mig.release_snapshot_pages(snap)     # the second call is a no-op
    assert sorted(pool.allocator.free) == list(range(32))
    assert pool.reserved == 0


def test_bench_switch_counts():
    """The port's twin of ``benchmarks/bench_switch.py``'s counts: yi-9b
    smoke, contexts of 448 tokens, batch 2, 16 new tokens, 8-token pages;
    the source prefills and decodes one step, then each restore path runs
    once.  The report must equal the committed ``BENCH_switch.json``'s, and
    the migrated streams the uninterrupted ones."""
    bench = json.loads((ROOT / "BENCH_switch.json").read_text())
    ctx_len, batch, new = bench["ctx_len"], bench["batch"], bench["new_tokens"]
    block = 8
    pkg = _package("torch", "yi-9b")
    blocks = 2 * batch * ((ctx_len + new) // block + 2)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, pkg.vocab, ctx_len).astype(np.int32)
               for _ in range(batch)]
    ref = pkg.engine(num_blocks=blocks, block_size=block, max_seqs=batch)
    for rid, p in enumerate(prompts):
        ref.submit(rid, p, new)
    want = {r.rid: list(r.generated) for r in ref.run_to_completion()}
    keys = ("handoff", "copied", "reprefilled", "pages_handoff",
            "pages_copied", "recompute_tokens")
    for committed in bench["results"]:
        mode = committed["mode"]
        pool_a = pkg.pool(blocks, block)
        pool_b = pool_a if mode == "handoff" else pkg.pool(blocks, block)
        src = pkg.engine(block_size=block, max_seqs=batch, pool=pool_a,
                         kv_quota=blocks)
        dst = pkg.engine(block_size=block, max_seqs=batch, pool=pool_b,
                         kv_quota=blocks)
        for rid, p in enumerate(prompts):
            src.submit(rid, p, new)
        src.step()                           # prefill (+ first token)
        src.step()                           # one decode step
        snaps = src.export_inflight(release=(mode == "reprefill"))
        src.release_all()
        report = tmig.migrate_batch(dst, snaps)
        assert {k: getattr(report, k) for k in keys} == {
            k: committed[k] for k in keys}, mode
        got = {r.rid: list(r.generated) for r in dst.run_to_completion()}
        assert got == want, mode
        assert dst.prefill_tokens == report.recompute_tokens, mode


def _drain_and_move_one(package):
    """Serve three requests on an engine of two slots, pause admission and
    drain two steps, move one in-flight request by ``export_request`` to a
    sibling view of the same pool while the source keeps serving, then
    resume admission and finish both engines."""
    pkg = _package(package, "yi-9b")
    pool = pkg.pool(48, 8)
    src = pkg.engine(block_size=8, max_seqs=2, pool=pool, kv_quota=24)
    dst = pkg.engine(block_size=8, max_seqs=2, pool=pool, kv_quota=24)
    for rid, (p, n) in enumerate(_jobs(pkg.vocab, 11,
                                       ((14, 9), (30, 3), (9, 7)))):
        src.submit(rid, p, n)
    src.step()
    drained = [(r.rid, list(r.generated)) for r in src.drain(max_steps=2)]
    seen = dict(drained=drained, admitting=src.admitting,
                waiting=[r.rid for r in src.waiting],
                active=sorted(r.rid for r in src.active.values()))
    snap = src.export_request(0)
    seen["snapshot"] = (snap.rid, list(snap.generated), list(snap.blocks),
                        snap.seq_len)
    seen["missing"] = src.export_request(42)
    report = pkg.mig.migrate_batch(dst, [snap])
    seen["report"] = dataclasses.asdict(report)
    src.resume_admission()
    tokens = dict(drained)
    for eng in (src, dst):
        tokens.update({r.rid: list(r.generated)
                       for r in eng.run_to_completion()})
    seen["tokens"] = tokens
    seen["counters"] = (_counters(src), _counters(dst))
    seen["pool"] = (list(pool.allocator.free), pool.reserved)
    return seen


def test_drain_and_export_request_match_jax():
    got = _drain_and_move_one("torch")
    assert got == _drain_and_move_one("jax")
    assert got["drained"] and got["waiting"] == [2]
    assert got["report"]["handoff"] == 1 and got["missing"] is None
    assert got["tokens"] == _uninterrupted_jobs(
        "yi-9b", 11, ((14, 9), (30, 3), (9, 7)))


@pytest.mark.parametrize("pool_kw,error", [
    (dict(block_size=16), "block_size"),
    (dict(dtype=torch.bfloat16), "dtype"),
    (dict(device="meta"), "lives on"),
])
def test_engine_refuses_a_foreign_pool(pool_kw, error):
    """A shared pool must have the engine's page size, dtype and device."""
    cfg, tp = _weights("yi-9b")[2:]
    kw = dict(dict(block_size=8, dtype=torch.float32, device="cpu"),
              **pool_kw)
    pool = BlockPool(cfg, 16, kw["block_size"], kw["dtype"],
                     device=kw["device"])
    with pytest.raises(ValueError, match=error):
        ServingEngine(cfg, tp, block_size=8, pool=pool, device="cpu")
