"""The port's compiled step (``serving.graphs``) against the JAX engine's
jit caches, on the CPU.

On the CPU a compiled step reuses its key's static buffers and captures
nothing, so these tests hold the buffer plumbing: a buffer left stale
between two calls of one key gives wrong tokens here too.  The JAX engine
compiles one prefill program per (group size, prompt length)
(``_prefill``), one decode program per (batch bucket, page bucket,
horizon) (``_fused``) and one chunk program per (chunk bucket, page
bucket) (``_chunk``); the port keeps one step entry per such key, and the
counts must be equal on the same streams (the one-shot prefill and the
sampled decode: ``test_torch_graphs_prefill_sampled.py``).  fp32, smoke
configs: greedy tokens are equal, the chunk forward on device scalars
equals its int form exactly and JAX's within ATOL = 1e-4.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _quickstart_job, _weights

import repro.models as jm
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.request import shared_prefix_prompts
from repro_torch import models as tm
from repro_torch.kernels import ops, ref
from repro_torch.serving.engine import LOAD_STATS_KEYS, ServingEngine
from repro_torch.serving.graphs import StepGraphs

ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bucketed_stream(eng, vocab):
    """``test_fused_step_compilations_bucketed``'s stream: the active set
    sweeps 1..8 and back."""
    rng = np.random.RandomState(4)
    for i in range(11):
        n = 6 + (i % 5) * 2
        eng.submit(i, rng.randint(0, vocab, n).astype(np.int32), 3 + (i % 6))
    return {r.rid: list(r.generated) for r in eng.run_to_completion()}


def _count_calls(eng) -> dict:
    """{kind: compiled-step calls} of ``eng``, counted from now on."""
    calls: dict = {}
    run = eng._steps.run

    def counting(key, *args):
        calls[key[0]] = calls.get(key[0], 0) + 1
        return run(key, *args)

    eng._steps.run = counting
    return calls


def _pair(arch, **kw):
    jcfg, jp, cfg, tp = _weights(arch)
    return (JaxEngine(jcfg, jp, **kw),
            ServingEngine(cfg, tp, device="cpu", **kw), cfg.vocab_size)


@pytest.mark.parametrize("horizon", [1, 8])
def test_decode_keys_match_the_jax_fused_cache(horizon):
    jeng, eng, vocab = _pair("yi-9b", num_blocks=256, block_size=8,
                             max_seqs=8, decode_horizon=horizon)
    calls = _count_calls(eng)
    assert _bucketed_stream(eng, vocab) == _bucketed_stream(jeng, vocab)
    n_keys = len(eng._steps.keys("decode"))
    n_prefill = len(eng._steps.keys("prefill"))
    assert n_keys == jeng._fused._cache_size()
    assert eng._steps.keys("chunk") == []
    # every horizon went through a key: built once, then replayed; a
    # prefill key ran eagerly once, was built at its second call and
    # replayed after that
    st = eng._steps
    assert calls["decode"] == eng.decode_syncs
    assert st.eager["prefill"] == n_prefill
    assert 0 < st.built["prefill"] < n_prefill
    assert eng.graph_captures == n_keys + st.built["prefill"]
    assert eng.graph_replays == (eng.decode_syncs - n_keys
                                 + calls["prefill"] - n_prefill
                                 - st.built["prefill"])
    assert eng.decode_syncs - n_keys > 0
    assert eng.decode_syncs == jeng.decode_syncs
    assert set(eng.load_stats()) == LOAD_STATS_KEYS


def test_chunk_keys_match_the_jax_chunk_cache():
    """The quickstart job in 8-token chunks at horizon 8."""
    kw = dict(num_blocks=128, block_size=8, max_seqs=4, decode_horizon=8,
              prefill_chunk_tokens=8)
    jeng, eng, vocab = _pair("yi-9b", **kw)
    assert _quickstart_job(eng, vocab) == _quickstart_job(jeng, vocab)
    assert len(eng._steps.keys("chunk")) == jeng._chunk._cache_size() > 1
    assert len(eng._steps.keys("decode")) == jeng._fused._cache_size()
    assert eng.graph_replays > 0


def test_prefix_hit_chunk_keys_match_jax():
    """Prefix-cache hits resume through the chunk forward at a query
    offset, one chunk of each uncached suffix."""
    kw = dict(num_blocks=64, block_size=8, max_seqs=2, prefix_cache=True)
    jeng, eng, vocab = _pair("yi-9b", **kw)
    prompts = shared_prefix_prompts(6, 24, 6, vocab=vocab, seed=3)

    def job(e):
        for rid, p in enumerate(prompts):
            e.submit(rid, p, 4 + rid % 3)
        return {r.rid: list(r.generated) for r in e.run_to_completion()}

    assert job(eng) == job(jeng)
    assert eng.prefix_cache.hits == jeng.prefix_cache.hits > 0
    assert len(eng._steps.keys("chunk")) == jeng._chunk._cache_size() > 0


@pytest.mark.parametrize("arch", ["hymba-1.5b", "olmoe-1b-7b"])
def test_graphed_tokens_equal_eager_tokens(arch):
    """SSM rows (hymba) and ``moe_dense`` (olmoe) inside the decode step."""
    _, _, cfg, tp = _weights(arch)
    kw = dict(num_blocks=256, block_size=8, max_seqs=8, decode_horizon=4)
    eager = ServingEngine(cfg, tp, device="cpu", graphs=False, **kw)
    graphed = ServingEngine(cfg, tp, device="cpu", **kw)
    want = _bucketed_stream(eager, cfg.vocab_size)
    assert _bucketed_stream(graphed, cfg.vocab_size) == want
    assert eager.graph_captures == eager.graph_replays == 0
    assert graphed.graph_replays > 0
    # the pools and SSM rows end equal to the bit
    for name in ("k", "v", "ssm", "conv"):
        a, b = getattr(eager.cache, name), getattr(graphed.cache, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a[:, :kw["max_seqs"]], b[:, :kw["max_seqs"]])


def test_one_key_with_other_slots_and_tokens():
    """A request decodes alone in slot 1 after its neighbour retires, a
    later one alone in slot 0: one decode key serves both with other slots
    and tokens in its buffers; a second pass builds the prefill keys its
    first ran eagerly, and a warm third pass captures nothing."""
    _, _, cfg, tp = _weights("yi-9b")
    kw = dict(num_blocks=64, block_size=8, max_seqs=2)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, 9).astype(np.int32)
               for _ in range(3)]

    def serve(eng, base):
        out = {}
        for wave in (((0, 4), (1, 12)), ((2, 6),)):
            for i, n in wave:
                eng.submit(base + i, prompts[i], n)
            out.update({r.rid - base: list(r.generated)
                        for r in eng.run_to_completion()})
        return out

    eager = ServingEngine(cfg, tp, device="cpu", graphs=False, **kw)
    graphed = ServingEngine(cfg, tp, device="cpu", **kw)
    seen: dict = {}
    run = graphed._steps.run

    def spy(key, inputs, step, reads):
        seen.setdefault(key, set()).add(tuple(inputs["slot_t"].tolist()))
        return run(key, inputs, step, reads)

    graphed._steps.run = spy
    want = serve(eager, 0)
    assert serve(graphed, 0) == want
    assert seen[("decode", 1, 2, 1)] == {(0,), (1,)}
    assert graphed._steps.built["prefill"] == 0
    assert serve(graphed, 100) == want
    assert graphed._steps.built["prefill"] == 2
    captures = graphed.graph_captures
    assert serve(graphed, 200) == want
    assert graphed.graph_captures == captures


def test_new_weights_drop_the_graphs():
    """A graph reads fixed addresses: new parameter tensors (or pools)
    drop every entry, and the keys build again."""
    _, _, cfg, tp = _weights("yi-9b")
    kw = dict(num_blocks=128, block_size=8, max_seqs=4, decode_horizon=4,
              prefill_chunk_tokens=8)
    eng = ServingEngine(cfg, tp, device="cpu", **kw)
    want = _quickstart_job(eng, cfg.vocab_size)
    assert eng.graph_captures == len(eng._steps.entries)
    eng.params = copy.deepcopy(tp)
    built = eng.graph_captures
    assert _quickstart_job(eng, cfg.vocab_size) == want
    # every entry now held was built on the new weights
    assert eng.graph_captures - built == len(eng._steps.entries) > 0


def test_eager_configurations_build_no_decode_step():
    """The dense mode's decode stays eager: the dense engine builds no
    decode step and, its prompts all chunked, no prefill step, but
    compiles its chunk forwards, and its tokens equal its eager twin's.
    A sampled paged engine compiles its decode horizons and one-shot
    prefills."""
    _, _, cfg, tp = _weights("yi-9b")
    kw = dict(num_blocks=128, block_size=8, max_seqs=4)
    dense = ServingEngine(cfg, tp, device="cpu", decode_mode="dense",
                          prefill_chunk_tokens=8, **kw)
    eager = ServingEngine(cfg, tp, device="cpu", decode_mode="dense",
                          prefill_chunk_tokens=8, graphs=False, **kw)
    assert (_quickstart_job(dense, cfg.vocab_size)
            == _quickstart_job(eager, cfg.vocab_size))
    assert dense._steps.keys("decode") == []
    assert dense._steps.keys("prefill") == []
    assert len(dense._steps.keys("chunk")) > 0 and dense.graph_replays > 0
    assert eager.graph_captures == 0
    sampled = ServingEngine(cfg, tp, device="cpu", greedy=False, **kw)
    _quickstart_job(sampled, cfg.vocab_size)
    assert len(sampled._steps.keys("decode")) > 0
    assert len(sampled._steps.keys("prefill")) > 0
    assert sampled.graph_replays > 0


# --------------------------------------------------------------------------
# The chunk forward on device scalars.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-2b"])
def test_prefill_chunk_on_device_scalars(arch):
    """A 90-token prompt in chunks of 32, 32 and 26 (bucketed to 32),
    crossing gemma2-smoke's 64-token window: ``start``/``n_valid`` as
    int32 scalars give the int form's logits and pools to the bit, and
    JAX's within ATOL."""
    jcfg, jp, cfg, tp = _weights(arch)
    r = np.random.RandomState(29)
    S, C, page = 90, 32, 8
    toks = r.randint(0, cfg.vocab_size, (1, S)).astype(np.int32)
    n = (S + page - 1) // page
    P = n + 4
    table = torch.from_numpy(r.permutation(P)[:n][None].astype(np.int32))
    shape = (cfg.n_layers, P + 1, cfg.n_kv_heads, page, cfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    pools = {form: (torch.zeros(shape), torch.zeros(shape))
             for form in ("int", "tensor")}
    for start in range(0, S, C):
        n_valid = min(C, S - start)
        buf = np.zeros((1, C), np.int32)
        buf[0, :n_valid] = toks[0, start:start + n_valid]
        t = torch.from_numpy(buf)
        jlogits, jk, jv = jm.prefill_chunk(
            jp, jcfg, jnp.asarray(buf), jk, jv, jnp.asarray(table.numpy()),
            jnp.int32(start), jnp.int32(n_valid), P)
        want = tm.prefill_chunk(tp, cfg, t, *pools["int"], table, start,
                                n_valid, P)
        got = tm.prefill_chunk(tp, cfg, t, *pools["tensor"], table,
                               torch.tensor(start, dtype=torch.int32),
                               torch.tensor(n_valid, dtype=torch.int32), P)
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=0)
    for a, b in zip(pools["int"], pools["tensor"]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(pools["tensor"][0][:, :P].numpy(),
                               np.asarray(jk)[:, :P], atol=ATOL, rtol=0)


def test_plain_prefill_takes_a_device_offset_per_row():
    """``ref.flash_attention_ref`` with a tensor offset, one scalar or one
    per batch row, equals the int form row by row (the plain version of
    the prefill kernel's device-offset form)."""
    r = np.random.RandomState(31)
    q = torch.from_numpy(r.randn(3, 16, 4, 32).astype(np.float32))
    k = torch.from_numpy(r.randn(3, 60, 2, 32).astype(np.float32))
    v = torch.from_numpy(r.randn(3, 60, 2, 32).astype(np.float32))
    offs = [0, 17, 44]
    kw = dict(softcap=20.0, window=24)
    got = ops.flash_attention(q, k, v, q_offset=torch.tensor(
        offs, dtype=torch.int32), **kw)
    for b, off in enumerate(offs):
        want = ref.flash_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                       q_offset=off, **kw)
        assert torch.equal(got[b:b + 1], want)
    one = ref.flash_attention_ref(q, k, v, q_offset=torch.tensor(
        17, dtype=torch.int32), **kw)
    assert torch.equal(one, ref.flash_attention_ref(q, k, v, q_offset=17,
                                                    **kw))


# --------------------------------------------------------------------------
# The step cache itself.
# --------------------------------------------------------------------------

def test_step_cache_counts_executions_and_offsets():
    """On the CPU each call runs the step once, on its key's buffers
    refilled with the call's inputs (a new offset included), and leaves
    the kernels' launch counts alone (on the card the kernels count their
    own launches, replays included); a new address in ``reads`` drops the
    entries, and ``release`` drops them too."""
    runs = []

    def step(x, off):
        runs.append(int(off))
        return x * 2 + off

    g = StepGraphs("cpu")
    reads = [torch.zeros(4)]
    before = ops.launch_counts()
    for i in range(3):
        out = g.run(("chunk", 8, 2), dict(x=torch.full((2,), float(i)),
                                          off=torch.tensor(5 * i)),
                    step, reads)
        assert torch.equal(out, torch.full((2,), 2.0 * i + 5 * i))
    assert runs == [0, 5, 10]
    assert ops.launch_counts() == before
    assert (g.captures, g.replays) == (1, 2)
    g.run(("decode", 1, 2, 4), dict(x=torch.ones(2), off=torch.tensor(0)),
          step, reads)
    assert g.keys("decode") == [("decode", 1, 2, 4)]
    assert g.keys("chunk") == [("chunk", 8, 2)]
    g.run(("chunk", 8, 2), dict(x=torch.ones(2), off=torch.tensor(1)),
          step, [torch.zeros(4)])
    assert g.keys("decode") == [] and g.captures == 3
    g.release()
    assert g.entries == {}
