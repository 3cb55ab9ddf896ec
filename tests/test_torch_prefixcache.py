"""The port's prefix cache against the JAX package's, on the same weights
and the same seeded jobs: the engine cases of ``tests/test_prefixcache.py``
(one-shot, chunked prefill resuming mid-prompt, partial-page copy-on-write,
horizon decode over shared pages, the evict -> restore round trip), and the
index and host tier without a model.  fp32 on the CPU.  In each case the
two packages must agree exactly on the tokens, ``load_stats()``, the
cache's counters, its index (keys, device blocks, host entries, LRU ticks),
the allocator's reference counts, ``pinned`` and free list, and
``pool.reserved``, after the run and again after ``drop_cold``.  Each JAX
scenario runs once per module.  The dense mode, gemma2-2b and an SSM model
are in ``test_torch_prefixcache_modes.py``; shared pools, migration and
the ``bench_prefix`` twin in ``test_torch_prefixcache_share.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_smoke_config as jax_smoke_config
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.kvcache import BlockPool as JaxPool
from repro.serving.prefixcache import PrefixCache as JaxPrefixCache
from repro.serving.request import shared_prefix_prompts
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ops
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import (BlockPool, gather_tokens,
                                         scatter_tokens)
from repro_torch.serving.prefixcache import PrefixCache

BS = 8


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _engine(package, arch, **kw):
    jcfg, jp, cfg, tp = _weights(arch)
    if package == "jax":
        return JaxEngine(jcfg, jp, **kw)
    return ServingEngine(cfg, tp, device="cpu", **kw)


def _jobs(arch, *, n=6, prefix=24, tail=6, n_templates=1, repeat=False):
    """(prompt, new tokens) per request: ``n`` prompts of one of
    ``n_templates`` shared templates and a unique tail, or (``repeat``)
    one prompt of three pages asked ``n`` times."""
    vocab = get_smoke_config(arch).vocab_size
    if repeat:
        prompt = np.random.RandomState(11).randint(
            0, vocab, 3 * BS).astype(np.int32)
        return [(prompt, 4 + i) for i in range(n)]
    prompts = shared_prefix_prompts(n, prefix, tail, vocab=vocab, seed=3,
                                    n_templates=n_templates)
    return [(p, 4 + (i % 3)) for i, p in enumerate(prompts)]


# each case: the arch, its jobs and the engine's options (64 blocks of 8
# tokens and 2 slots unless set; few slots stagger the admissions, so later
# requests admit after earlier ones published their pages)
CASES = {
    "one-shot": dict(arch="yi-9b", jobs={}, engine={}),
    "chunked": dict(arch="yi-9b", jobs={},
                    engine=dict(prefill_chunk_tokens=BS)),
    # identical prompts: the match is capped at prompt_len - 1, mid-page
    "cow": dict(arch="yi-9b", jobs=dict(n=3, repeat=True),
                engine=dict(max_seqs=1)),
    "horizon": dict(arch="yi-9b", jobs={}, engine=dict(decode_horizon=4)),
    # a pool too small for two templates' pages: LRU eviction to the host
    # tier and restores on the next visit (pure templates, no tail pages to
    # absorb the pressure)
    "evict": dict(arch="yi-9b", jobs=dict(n=8, prefix=32, tail=0,
                                          n_templates=2),
                  engine=dict(num_blocks=9, max_seqs=1)),
    # the cases of test_torch_prefixcache_modes.py
    "dense": dict(arch="yi-9b", jobs=dict(n=4),
                  engine=dict(decode_mode="dense")),
    # resumed queries at positions 72-77 reach past the 64-token window
    "gemma2-window": dict(arch="gemma2-2b", jobs=dict(n=4, prefix=72),
                          engine={}),
    "ssm-hymba": dict(arch="hymba-1.5b", jobs={}, engine={}),
}
MODES = ("dense", "gemma2-window", "ssm-hymba")


def _serve(package, case, cache=True):
    kw = dict(dict(num_blocks=64, max_seqs=2), **case["engine"])
    eng = _engine(package, case["arch"], block_size=BS, prefix_cache=cache,
                  **kw)
    for rid, (p, n) in enumerate(_jobs(case["arch"], **case["jobs"])):
        eng.submit(rid, p, n)
    tokens = {r.rid: list(r.generated) for r in eng.run_to_completion()}
    return tokens, eng


def cache_state(pool, pc) -> dict:
    """The pool's reference counts, free list and reservations and the
    cache's counters and index, as plain values."""
    a = pool.allocator
    st = dict(free=list(a.free), refs=np.asarray(a.refs).tolist(),
              pinned=a.pinned, reserved=pool.reserved)
    if pc is not None:
        st["counters"] = {k: getattr(pc, k) for k in (
            "hits", "misses", "hit_tokens", "published_pages",
            "evicted_bytes", "restored_bytes", "dropped_pages")}
        st["index"] = [(key, e.block, e.host is not None, e.tick)
                       for key, e in pc.index.items()]
        st["stats"] = pc.stats()
    return st


def engine_state(eng) -> dict:
    return dict(cache_state(eng.cache.pool, eng.prefix_cache),
                load=eng.load_stats(), events=list(eng.prefix_events),
                prefill_tokens=eng.prefill_tokens, steps=eng.steps,
                decode_syncs=eng.decode_syncs)


@functools.lru_cache(maxsize=None)
def _scenario(name, package):
    """Serve the case's jobs with the cache on; the state after the run,
    then after ``drop_cold``."""
    tokens, eng = _serve(package, CASES[name])
    got = dict(tokens=tokens, state=engine_state(eng))
    pc = eng.prefix_cache
    got["dropped"] = pc.drop_cold() if pc is not None else None
    got["after_drop"] = cache_state(eng.cache.pool, pc)
    got["num_blocks"] = eng.cache.pool.num_blocks
    return got


def check_matches_jax(name):
    got, want = _scenario(name, "torch"), _scenario(name, "jax")
    assert got["tokens"] == want["tokens"]
    for key in want["state"]:
        assert got["state"][key] == want["state"][key], key
    assert got["dropped"] == want["dropped"]
    assert got["after_drop"] == want["after_drop"]


def check_cache_on_equals_cache_off(name):
    """The cache is invisible in the tokens and cuts the prefill forward's
    tokens."""
    off, eng_off = _serve("torch", CASES[name], cache=False)
    got = _scenario(name, "torch")
    assert got["tokens"] == off
    assert got["state"]["counters"]["hits"] > 0
    assert got["state"]["prefill_tokens"] < eng_off.prefill_tokens
    assert eng_off.load_stats()["prefix_hits"] == 0


@pytest.mark.parametrize("name", [n for n in CASES if n not in MODES])
def test_prefix_cache_matches_jax(name):
    check_matches_jax(name)


@pytest.mark.parametrize("name", [n for n in CASES if n not in MODES])
def test_cache_on_equals_cache_off(name):
    check_cache_on_equals_cache_off(name)


def test_partial_page_copy_on_write_counts():
    """The repeats prefill only their last prompt token (the copied page
    carries the rest): 3 * BS + 1 + 1 forward tokens in all."""
    st = _scenario("cow", "torch")["state"]
    assert st["prefill_tokens"] == 3 * BS + 2
    assert st["counters"]["hits"] == 2
    assert st["events"] == [(0, 0, 3 * BS), (1, 3 * BS - 1, 3 * BS),
                            (2, 3 * BS - 1, 3 * BS)]


def test_evict_restore_round_trip_counts():
    st = _scenario("evict", "torch")["state"]
    cfg = get_smoke_config("yi-9b")
    page = 2 * cfg.n_layers * cfg.n_kv_heads * BS * cfg.head_dim * 4
    ev, rs = (st["counters"]["evicted_bytes"],
              st["counters"]["restored_bytes"])
    assert ev > 0 and rs > 0, "the small pool never used the host tier"
    assert ev % page == 0 and rs % page == 0


def check_counted_once_and_decref(name):
    """After a cached run drains, every reservation is returned, nothing is
    pinned, the only references left are the index's own (cold pages),
    and dropping them frees the whole pool."""
    got = _scenario(name, "torch")
    st, n = got["state"], got["num_blocks"]
    assert st["reserved"] == 0 and st["pinned"] == 0
    held = [b for b, r in enumerate(st["refs"]) if r > 0]
    assert len(held) + len(st["free"]) == n
    on_device = sorted(e[1] for e in st["index"] if e[1] is not None)
    assert on_device == held and all(st["refs"][b] == 1 for b in held)
    assert st["stats"]["cold_blocks"] == len(on_device)
    assert got["dropped"] == len(on_device)
    assert sorted(got["after_drop"]["free"]) == list(range(n))
    assert st["load"]["free_blocks_effective"] == n + len(on_device)


@pytest.mark.parametrize("name", ["one-shot", "horizon", "chunked"])
def test_shared_pages_counted_once_and_decref(name):
    check_counted_once_and_decref(name)


# --------------------------------------------------------------------------
# The index and the host tier, without a model.
# --------------------------------------------------------------------------


def _pool(package, n):
    jcfg, _, cfg, _ = _weights("yi-9b")
    if package == "jax":
        return JaxPool(jcfg, n, BS, jnp.float32, 1), JaxPrefixCache
    return BlockPool(cfg, n, BS, torch.float32, device="cpu"), PrefixCache


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_match_requires_identical_prefix(package):
    pool, cache_cls = _pool(package, 8)
    pc = cache_cls(pool)
    stream = np.random.RandomState(9).randint(0, 100, 3 * BS).astype(
        np.int32)
    pc.publish(stream, pool.allocator.alloc(3))
    seen = []
    m = pc.match(stream, 3 * BS - 1)        # capped mid-page: copy-on-write
    seen.append((m.cached_tokens, m.cow, len(m.keys)))
    other = stream.copy()
    other[BS + 2] += 1                       # kills pages 1 and 2 (chained)
    m = pc.match(other, 3 * BS - 1)
    seen.append((m.cached_tokens, m.cow, len(m.keys)))
    other[0] += 1                            # nothing matches
    m = pc.match(other, 3 * BS - 1)
    seen.append((m.cached_tokens, m.cow, len(m.keys)))
    assert seen == [(3 * BS - 1, True, 3), (BS, False, 1), (0, False, 0)]


def test_evict_restore_preserves_bytes():
    """Evict a page, overwrite the block it freed, restore the page: the
    bytes come back exactly, because the host copy never shares storage
    with the pool (on the CPU ``.cpu()`` would return the pool itself)."""
    pool, _ = _pool("torch", 4)
    pc = PrefixCache(pool)
    (b,) = pool.allocator.alloc(1)
    rng = np.random.RandomState(5)
    cfg = pool.cfg
    shape = (cfg.n_layers, BS, cfg.n_kv_heads, cfg.head_dim)
    k = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    v = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    scatter_tokens(pool, [b], k, v)
    tokens = rng.randint(0, 100, BS).astype(np.int32)
    pc.publish(tokens, [b])
    pool.allocator.release([b])             # the index's reference remains
    (e,) = pc.index.values()
    pc._evict(e)
    assert e.block is None and pool.allocator.n_free == 4
    host_ptr = e.host.untyped_storage().data_ptr()
    assert host_ptr != pool.k.untyped_storage().data_ptr()
    assert host_ptr != pool.v.untyped_storage().data_ptr()
    # the freed block is reallocated and overwritten at once
    (again,) = pool.allocator.alloc(1)
    assert again == b
    scatter_tokens(pool, [again], -k, -v)
    pool.allocator.release([again])
    cached, shared, cow = pc.attach(pc.match(tokens, BS))
    assert (cached, shared, cow) == (BS, [e.block], None)
    k2, v2 = gather_tokens(pool, [e.block], BS)
    assert torch.equal(k2, k) and torch.equal(v2, v)
    assert pc.evicted_bytes == pc.restored_bytes == pool.page_nbytes
    assert pool.page_nbytes == 2 * k.numel() * 4


# --------------------------------------------------------------------------
# What no token test shows: shared pages stay as they were, and the
# kernels get contiguous inputs.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["one-shot", "chunked", "cow", "evict"])
def test_index_pages_never_change(name):
    """Step the port's engine and, after every step, hold each page the
    index holds on the device (and each restored one) against its bytes
    when first seen: a resumed prefill or a decode write never lands in a
    shared page."""
    case = CASES[name]
    kw = dict(dict(num_blocks=64, max_seqs=2), **case["engine"])
    eng = _engine("torch", case["arch"], block_size=BS, prefix_cache=True,
                  **kw)
    for rid, (p, n) in enumerate(_jobs(case["arch"], **case["jobs"])):
        eng.submit(rid, p, n)
    pool, pc = eng.cache.pool, eng.prefix_cache
    first: dict = {}
    checked = 0
    while eng.waiting or eng.active:
        eng.step()
        for key, e in pc.index.items():
            if e.block is None:
                continue
            kv = gather_tokens(pool, [e.block], BS)
            if key not in first:
                first[key] = kv
                continue
            assert all(torch.equal(a, b) for a, b in zip(kv, first[key]))
            checked += 1
    assert checked > 0 and pc.hits > 0


def test_single_page_hit_hands_the_kernels_contiguous_inputs(monkeypatch):
    """A hit whose cached prefix is a single page: the resumed prefill
    gathers the prefix through a one-page table slice (the strided case of
    ``test_chunk_and_dense_decode_hand_the_kernels_contiguous_inputs``),
    and the kernels take raw pointers."""
    seen = []

    def contiguous_only(fn):
        def check(*args, **kw):
            seen.append(all(a.is_contiguous() for a in args
                            if isinstance(a, torch.Tensor)))
            return fn(*args, **kw)
        return check

    for name in ("flash_attention", "paged_decode"):
        monkeypatch.setattr(ops, name, contiguous_only(getattr(ops, name)))
    jobs = _jobs("yi-9b", n=3, prefix=BS, tail=3)
    eng = _engine("torch", "yi-9b", block_size=BS, num_blocks=16,
                  max_seqs=1, prefix_cache=True)
    for rid, (p, n) in enumerate(jobs):
        eng.submit(rid, p, n)
    eng.run_to_completion()
    assert eng.prefix_cache.hits == 2 and eng.prefill_tokens == 11 + 2 * 3
    assert seen and all(seen)
