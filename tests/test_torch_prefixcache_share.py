"""The port's prefix cache across engines, against the JAX package's on the
same weights and seeded jobs: two engines on one pool share one index,
migration carries the shared pages (a cache hit handed off with its
``n_shared``, copied to another pool, re-prefilled into a hit), and
``release_snapshot_pages`` leaves the index's pages alive.  The tokens,
the ``MigrationReport``, the snapshots' pages and each pool's reference
counts, free list, reservations and index must equal the JAX package's.
Last, the twin of ``benchmarks/bench_prefix.py``'s counts
(``BENCH_prefix.json``).  fp32 on the CPU; each JAX scenario runs once per
module.
"""
import dataclasses
import functools
import json
import pathlib

import pytest
from test_torch_prefixcache import _engine, _jobs, cache_state

import repro.serving.migration as jmig
from repro.serving.kvcache import BlockPool as JaxPool
from repro.serving.request import shared_prefix_prompts
from repro_torch.configs import get_smoke_config
from repro_torch.serving import migration as tmig
from repro_torch.serving.kvcache import BlockPool

ROOT = pathlib.Path(__file__).resolve().parents[1]
BS = 8


def _pool(package, n=64):
    if package == "jax":
        from repro.configs import get_smoke_config as jax_smoke_config
        return JaxPool(jax_smoke_config("yi-9b"), n, BS)
    return BlockPool(get_smoke_config("yi-9b"), n, BS, device="cpu")


def _state(pools, engines) -> dict:
    return dict(pools=[cache_state(p, p.prefix_cache) for p in pools],
                load=[e.load_stats() for e in engines],
                events=[list(e.prefix_events) for e in engines])


@functools.lru_cache(maxsize=None)
def _two_engines(package):
    """Two engines on one pool, each with a quota of half of it: the first
    serves one request, the second then serves the rest and hits the
    first's pages."""
    pool = _pool(package)
    a, b = (_engine(package, "yi-9b", block_size=BS, max_seqs=2, pool=pool,
                    kv_quota=32, prefix_cache=True) for _ in range(2))
    jobs = _jobs("yi-9b", n=4)
    a.submit(0, *jobs[0])
    tokens = {r.rid: list(r.generated) for r in a.run_to_completion()}
    for rid, (p, n) in enumerate(jobs[1:], 1):
        b.submit(rid, p, n)
    tokens.update({r.rid: list(r.generated) for r in b.run_to_completion()})
    return dict(tokens=tokens, state=_state([pool], [a, b]),
                one_index=a.prefix_cache is b.prefix_cache
                is pool.prefix_cache)


def test_engines_on_one_pool_share_one_index():
    got = _two_engines("torch")
    assert got == _two_engines("jax")
    assert got["one_index"]
    load_a, load_b = got["state"]["load"]
    assert load_b["prefix_hits"] == 3 and load_b["prefix_misses"] == 1
    assert got["state"]["events"][1] == [(rid, 24, 30) for rid in (1, 2, 3)]


# each case: one shared pool or two, whether the export releases the pages
MIGRATIONS = {"handoff": dict(shared=True, release=False),
              "copy": dict(shared=False, release=False),
              "reprefill": dict(shared=True, release=True)}


@functools.lru_cache(maxsize=None)
def _migration(name, package):
    """Four shared-prefix requests on a source engine with the cache: the
    first alone to its first token, then the rest (hits) for two steps;
    export them all and migrate them to a destination that has the cache
    too, which finishes them."""
    case = MIGRATIONS[name]
    pools = [_pool(package)] if case["shared"] else [_pool(package),
                                                     _pool(package)]
    src, dst = (_engine(package, "yi-9b", block_size=BS, max_seqs=4,
                        pool=p, kv_quota=32 if case["shared"] else None,
                        prefix_cache=True)
                for p in (pools[0], pools[-1]))
    jobs = _jobs("yi-9b", n=4)
    src.submit(0, jobs[0][0], 8)
    src.step()
    for rid, (p, _) in enumerate(jobs[1:], 1):
        src.submit(rid, p, 8)
    src.step()
    src.step()
    snaps = src.export_inflight(release=case["release"])
    held = [(s.rid, None if s.blocks is None else list(s.blocks), s.n_shared)
            for s in snaps]
    src.release_all()
    report = (jmig if package == "jax" else tmig).migrate_batch(dst, snaps)
    tokens = {r.rid: list(r.generated) for r in dst.run_to_completion()}
    return dict(tokens=tokens, held=held, report=dataclasses.asdict(report),
                state=_state(pools, [src, dst]),
                prefill=(src.prefill_tokens, dst.prefill_tokens))


def _uninterrupted():
    """The port's streams of the migration job on one engine."""
    eng = _engine("torch", "yi-9b", block_size=BS, max_seqs=4,
                  num_blocks=64, prefix_cache=True)
    jobs = _jobs("yi-9b", n=4)
    eng.submit(0, jobs[0][0], 8)
    eng.step()
    for rid, (p, _) in enumerate(jobs[1:], 1):
        eng.submit(rid, p, 8)
    return {r.rid: list(r.generated) for r in eng.run_to_completion()}


@pytest.mark.parametrize("name", list(MIGRATIONS))
def test_migration_with_the_cache_matches_jax(name):
    got = _migration(name, "torch")
    assert got == _migration(name, "jax")
    assert got["tokens"] == _uninterrupted()
    rep = got["report"]
    if name == "reprefill":
        # the re-prefill hits the index: each request's own prompt pages
        assert rep["reprefilled"] == 4
        assert got["prefill"][1] < rep["recompute_tokens"]
        assert [c > 0 for _, c, _ in got["state"]["events"][1]] == [True] * 4
    else:
        assert rep["handoff" if name == "handoff" else "copied"] == 4
        # the three hits carried their three shared template pages
        assert [n for _, _, n in got["held"]] == [0, 3, 3, 3]
        assert got["prefill"][1] == 0
    # nothing reserved or pinned is left, and every block is free or held
    # by an index at count 1
    for st in got["state"]["pools"]:
        assert st["reserved"] == 0 and st["pinned"] == 0
        held = sorted(e[1] for e in st["index"] if e[1] is not None)
        assert sorted(b for b, r in enumerate(st["refs"]) if r) == held
        assert len(st["free"]) + len(held) == 64


@functools.lru_cache(maxsize=None)
def _released(package):
    """Export the hits with their pages and release the snapshots."""
    pool = _pool(package)
    eng = _engine(package, "yi-9b", block_size=BS, max_seqs=4, pool=pool,
                  kv_quota=64, prefix_cache=True)
    jobs = _jobs("yi-9b", n=4)
    eng.submit(0, jobs[0][0], 8)
    eng.step()
    for rid, (p, _) in enumerate(jobs[1:], 1):
        eng.submit(rid, p, 8)
    eng.step()
    snaps = eng.export_inflight(release=False)
    mig = jmig if package == "jax" else tmig
    for s in snaps:
        mig.release_snapshot_pages(s)
        mig.release_snapshot_pages(s)        # the second call drops nothing
    return cache_state(pool, pool.prefix_cache)


def test_release_snapshot_pages_leaves_the_index_alive():
    got = _released("torch")
    assert got == _released("jax")
    on_device = [e[1] for e in got["index"] if e[1] is not None]
    assert on_device and all(got["refs"][b] == 1 for b in on_device)
    assert not set(on_device) & set(got["free"])
    assert got["reserved"] == 0 and got["pinned"] == 0
    assert len(got["free"]) + len(on_device) == 64


# --------------------------------------------------------------------------
# The twin of benchmarks/bench_prefix.py's counts.
# --------------------------------------------------------------------------


def _bench_rounds(package, cache, bench):
    """bench_prefix's trace through one engine: one template, 6 requests a
    round, 3 rounds, each request submitted alone and served to its end.
    Returns the streams, each round's prefill tokens and the engine."""
    n_req, rounds = 6, bench["rounds"]
    eng = _engine(package, "yi-9b", num_blocks=96, block_size=BS,
                  max_seqs=2, prefix_cache=cache)
    prompts = shared_prefix_prompts(
        n_req * rounds, bench["prefix_len"], bench["tail_len"],
        vocab=get_smoke_config("yi-9b").vocab_size, seed=3)
    tokens, per_round = {}, []
    for r in range(rounds):
        mark = eng.prefill_tokens
        for rid in range(r * n_req, (r + 1) * n_req):
            eng.submit(rid, prompts[rid], bench["new_tokens"])
            tokens.update({x.rid: list(x.generated)
                           for x in eng.run_to_completion()})
        per_round.append(eng.prefill_tokens - mark)
    return tokens, per_round, eng


def test_bench_prefix_counts():
    """yi-9b smoke, 8-token pages, template 192, tail 8, 8 new tokens, 6
    requests a round, 3 rounds, 96 blocks, 2 slots: the port reproduces
    ``BENCH_prefix.json``'s counts (a warm round's prefill tokens 1200 ->
    48; 17 hits, 1 miss, 3264 hit tokens, nothing evicted or restored),
    with the same greedy tokens with the cache on and off, and equal to
    the JAX engine's.  No time is compared."""
    bench = json.loads((ROOT / "BENCH_prefix.json").read_text())
    want = {r["mode"]: r for r in bench["results"]}
    off, off_rounds, _ = _bench_rounds("torch", False, bench)
    on, on_rounds, eng = _bench_rounds("torch", True, bench)
    assert off_rounds[1:] == [want["off"]["prefill_tokens"]] * 2 == [1200] * 2
    assert on_rounds[1:] == [want["on"]["prefill_tokens"]] * 2 == [48] * 2
    pc = eng.prefix_cache
    got = {k: getattr(pc, k) for k in ("hits", "misses", "hit_tokens",
                                       "evicted_bytes", "restored_bytes")}
    assert got == {k: want["on"][k] for k in got}
    assert got["hits"] == 17 and got["misses"] == 1
    assert got["hit_tokens"] == 3264
    assert on == off
    jax_on, jax_rounds, _ = _bench_rounds("jax", True, bench)
    assert on == jax_on and on_rounds == jax_rounds
