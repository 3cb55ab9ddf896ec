"""The one-shot prefill and the sampled decode horizon as compiled steps
(``serving.graphs``) against the JAX engine's ``_prefill`` and sampled
``_fused`` jit caches and against the eager engine, on the CPU.

The JAX engine compiles one prefill program per (group size, prompt
length) and, greedy or sampled, one decode program per (batch bucket,
page bucket, horizon); the port keeps one step entry per such key.  fp32,
smoke configs: a graphed engine's greedy streams and its pool after the
prefill (K/V pages, SSM and conv rows) equal the eager engine's to the
bit and the JAX engine's within ATOL = 1e-4.  Sampled streams come from
the counter-based sampler (``sampling.sample_step``), not JAX's stream:
they are held equal between the graphed and the eager engine and across
horizons, and the sampler's frequencies are held to the softmax within
FREQ_ATOL.
"""
import types

import numpy as np
import pytest
import torch
from test_torch_engine import _device_state_close, _weights
from test_torch_graphs import _bucketed_stream, _count_calls, _pair

from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.models import sampling
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.graphs import StepGraphs

ATOL = 1e-4
# the counter sampler's frequencies over N_DRAWS draws of a fixed 6-token
# distribution: one frequency's standard deviation is at most
# 0.5 / sqrt(N_DRAWS) ~ 1e-3, so 6e-3 is six of them
N_ROWS, N_STEPS, SEEDS = 512, 256, (0, 11)
N_DRAWS = N_ROWS * N_STEPS * len(SEEDS)
FREQ_ATOL = 6e-3
KW = dict(num_blocks=256, block_size=8, max_seqs=8)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sampled_stream(eng, vocab, n: int = 6):
    """Six requests of 5-16 tokens, 9-20 new tokens each, all submitted at
    once (two of them wait for a slot)."""
    rng = np.random.RandomState(12)
    for i in range(n):
        eng.submit(i, rng.randint(0, vocab, 5 + 2 * i).astype(np.int32),
                   9 + (i * 5) % 12)
    return {r.rid: list(r.generated) for r in eng.run_to_completion()}


# --------------------------------------------------------------------------
# The one-shot prefill.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-9b", "hymba-1.5b"])
def test_prefill_keys_match_the_jax_prefill_cache(arch):
    """One prefill key per (group size, prompt length), as many as the
    JAX engine's ``_prefill`` compiles on the same stream: each runs
    eagerly at its first call, is built at its second and replayed
    after."""
    jeng, eng, vocab = _pair(arch, **KW, decode_horizon=4)
    calls = _count_calls(eng)
    assert _bucketed_stream(eng, vocab) == _bucketed_stream(jeng, vocab)
    keys = eng._steps.keys("prefill")
    assert len(keys) == jeng._prefill._cache_size() > 1
    assert {k[2] for k in keys} == {6, 8, 10, 12, 14}
    assert calls["prefill"] > len(keys)
    st = eng._steps
    assert st.eager["prefill"] == len(keys)
    assert len(st.entries) - len(st.keys("decode")) == st.built["prefill"]
    assert calls["prefill"] == (st.eager["prefill"] + st.built["prefill"]
                                + st.replayed["prefill"])
    assert eng.graph_captures == len(st.entries)


@pytest.mark.parametrize("arch", ["yi-9b", "hymba-1.5b", "mamba2-370m"])
def test_graphed_prefill_writes_the_eager_pool(arch):
    """After a first pass of 3 prompts (one group of two, one of one: each
    key's eager call), one step that prefills them again builds both
    prefill keys, and a graphed engine's K/V pages and SSM/conv rows then
    equal the eager engine's to the bit and the JAX engine's within ATOL;
    the streams then stay equal to the end."""
    jcfg, jp, cfg, tp = _weights(arch)
    kw = dict(num_blocks=64, block_size=8, max_seqs=4, decode_horizon=4)
    engines = [JaxEngine(jcfg, jp, **kw),
               ServingEngine(cfg, tp, device="cpu", graphs=False, **kw),
               ServingEngine(cfg, tp, device="cpu", **kw)]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (13, 13, 21)]
    for e in engines:
        for rid0 in (100, 0):
            for rid, p in enumerate(prompts):
                e.submit(rid0 + rid, p, 6)
            if rid0:
                e.run_to_completion()
        e.step()
    jeng, eager, graphed = engines
    assert graphed._steps.keys("prefill") == [("prefill", 2, 13),
                                              ("prefill", 1, 21)]
    assert graphed._steps.built["prefill"] == 2
    for name in ("k", "v", "ssm", "conv"):
        a, b = getattr(eager.cache, name), getattr(graphed.cache, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), name
    _device_state_close(graphed, jeng)
    want = {r.rid: r.generated for r in eager.run_to_completion()}
    got = {r.rid: r.generated for r in graphed.run_to_completion()}
    assert got == want == {r.rid: r.generated
                           for r in jeng.run_to_completion()}


def test_prefill_replay_reads_its_new_slots_and_pages():
    """Passes of the same prompts land in other slots and pages: the
    second builds every prefill key the first ran once, and in a warm
    third every prefill replays its key's entry on the new inputs, nothing
    is built, and the tokens repeat."""
    _, _, cfg, tp = _weights("yi-9b")
    eng = ServingEngine(cfg, tp, device="cpu", **KW, decode_horizon=8)
    first = _bucketed_stream(eng, cfg.vocab_size)
    assert _bucketed_stream(eng, cfg.vocab_size) == first
    st = eng._steps
    assert st.built["prefill"] == len(st.keys("prefill"))
    captures, replayed = eng.graph_captures, st.replayed["prefill"]
    calls = _count_calls(eng)
    assert _bucketed_stream(eng, cfg.vocab_size) == first
    assert eng.graph_captures == captures
    assert calls["prefill"] >= len(st.keys("prefill"))
    assert st.replayed["prefill"] - replayed == calls["prefill"]


def test_prefill_keys_build_on_reuse_and_the_least_recent_goes():
    """A prefill key's first call runs the step on the caller's inputs and
    builds nothing, its second builds the entry, its third replays it; at
    ``reuse_cap`` entries a build drops the least recently called prefill
    entry, whose key builds again (without an eager call) when it comes
    back.  Decode keys build at their first call and are not capped."""
    runs = []

    def step(x):
        runs.append(float(x[0]))
        return x + 1

    g = StepGraphs("cpu", reuse_cap=2)
    reads = [torch.zeros(1)]

    def call(kind, n, v):
        x = torch.full((1,), float(v))
        assert torch.equal(g.run((kind, 1, n), dict(x=x), step, reads),
                           x + 1)

    call("prefill", 5, 1)
    assert g.entries == {} and g.eager["prefill"] == 1
    assert g.keys("prefill") == [("prefill", 1, 5)]
    call("prefill", 5, 2)
    call("prefill", 5, 3)
    assert (g.built["prefill"], g.replayed["prefill"]) == (1, 1)
    for n in (6, 7):
        call("prefill", n, n)
        call("prefill", n, n)
    assert list(g.entries) == [("prefill", 1, 6), ("prefill", 1, 7)]
    assert g.evicted["prefill"] == 1 and g.eager["prefill"] == 3
    call("prefill", 5, 4)
    assert list(g.entries) == [("prefill", 1, 7), ("prefill", 1, 5)]
    assert (g.eager["prefill"], g.built["prefill"],
            g.evicted["prefill"]) == (3, 4, 2)
    for n in (1, 2, 3):
        call("decode", n, n)
    assert g.built["decode"] == 3 and len(g.entries) == 5
    assert runs == [1, 2, 3, 6, 6, 7, 7, 4, 1, 2, 3]


# --------------------------------------------------------------------------
# The sampled decode horizon.
# --------------------------------------------------------------------------

def test_sampled_decode_keys_match_the_jax_fused_cache():
    """A sampled engine compiles its decode horizons: as many keys as a
    sampled JAX engine's ``_fused`` on the same schedule (the streams
    differ: each package its own sampler)."""
    jeng, eng, vocab = _pair("yi-9b", **KW, decode_horizon=8, greedy=False)
    _bucketed_stream(eng, vocab)
    _bucketed_stream(jeng, vocab)
    assert eng.decode_syncs == jeng.decode_syncs
    assert len(eng._steps.keys("decode")) == jeng._fused._cache_size()
    assert len(eng._steps.keys("prefill")) == jeng._prefill._cache_size()


@pytest.mark.parametrize("arch", ["yi-9b", "hymba-1.5b"])
def test_sampled_streams_equal_eager_and_across_horizons(arch):
    """The graphed engine at horizons 1, 4 and 8 gives the eager engine's
    sampled streams: the noise of a step is keyed by (seed, global step,
    row) on the device, so neither the horizon nor a replay moves it."""
    _, _, cfg, tp = _weights(arch)
    kw = dict(KW, max_seqs=4, greedy=False, seed=3)
    want = _sampled_stream(ServingEngine(cfg, tp, device="cpu",
                                         graphs=False, **kw), cfg.vocab_size)
    for horizon in (1, 4, 8):
        eng = ServingEngine(cfg, tp, device="cpu", decode_horizon=horizon,
                            **kw)
        assert _sampled_stream(eng, cfg.vocab_size) == want, horizon
        assert eng.graph_replays > 0
    greedy = _sampled_stream(ServingEngine(cfg, tp, device="cpu",
                                           **dict(kw, greedy=True)),
                             cfg.vocab_size)
    assert greedy != want


def test_step0_reaches_the_decode_step_as_a_device_buffer():
    """Each dispatch hands its global step to the step as an int64 tensor
    on the engine's device, advancing by the horizon."""
    _, _, cfg, tp = _weights("yi-9b")
    eng = ServingEngine(cfg, tp, device="cpu", **KW, decode_horizon=4,
                        greedy=False)
    seen = []
    run = eng._steps.run

    def spy(key, inputs, step, reads):
        if key[0] == "decode":
            t = inputs["step0"]
            assert t.dtype == torch.int64 and t.device == eng.device
            seen.append((int(t), key[3]))
        return run(key, inputs, step, reads)

    eng._steps.run = spy
    _sampled_stream(eng, cfg.vocab_size)
    starts = [s for s, _ in seen]
    assert starts == list(np.cumsum([0] + [h for _, h in seen[:-1]]))
    assert eng._sample_step == sum(h for _, h in seen) > len(seen)


def test_a_baked_python_int_replays_stale_on_the_cpu():
    """A step that bakes a Python int into its closure is replayed as it
    was built, on the CPU as a captured graph is on the card: the second
    call's own constant is not seen.  The step's buffer form draws anew."""
    cfg = types.SimpleNamespace(vocab_size=50)
    logits = torch.zeros(4, 64)
    reads = [logits]
    g = StepGraphs("cpu")

    def baked(step):
        return lambda logits: sampling.sample_step(logits, cfg, 7, step)

    first = g.run(("decode", 4, 1, 1), dict(logits=logits), baked(0), reads)
    again = g.run(("decode", 4, 1, 1), dict(logits=logits), baked(5), reads)
    assert torch.equal(again, first)
    fresh = sampling.sample_step(logits, cfg, 7, 5)
    assert not torch.equal(fresh, first)

    def buffered(logits, step):
        return sampling.sample_step(logits, cfg, 7, step)

    for s in (0, 5):
        out = g.run(("decode", 4, 1, 2), dict(
            logits=logits, step=torch.tensor(s, dtype=torch.int64)),
            buffered, reads)
        assert torch.equal(out, sampling.sample_step(logits, cfg, 7, s))


# --------------------------------------------------------------------------
# The counter-based sampler.
# --------------------------------------------------------------------------

def _fmix32_py(x: int) -> int:
    """MurmurHash3's finaliser on Python ints (no overflow)."""
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


def test_counter_hash_is_exact_integer_arithmetic():
    """The int64 hash equals the same hash on Python's unbounded ints for
    inputs across [0, 2^32), the top included: no intermediate wraps, so
    the CPU and the card give the same bits."""
    rng = np.random.RandomState(1)
    xs = np.concatenate([rng.randint(0, 2 ** 32, 4000, dtype=np.int64),
                         [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]])
    got = sampling._fmix32(torch.from_numpy(xs)).tolist()
    assert got == [_fmix32_py(int(x)) for x in xs]
    c = 0xC2B2AE35
    assert (sampling._mul32(torch.from_numpy(xs), c).tolist()
            == [(int(x) * c) & 0xFFFFFFFF for x in xs])


def test_counter_sampler_frequencies_match_softmax():
    """Over many (seed, step, row) draws of one 6-token distribution the
    sampler's frequencies are softmax(logits / T) within FREQ_ATOL, at
    T = 1 and T = 0.5; the padded vocab tail is never drawn."""
    cfg = types.SimpleNamespace(vocab_size=6)
    base = torch.tensor([1.5, 0.0, -1.0, 0.7, 0.2, -2.5, 3.0, 3.0])
    logits = base.expand(N_ROWS, 8).contiguous()
    for temp in (1.0, 0.5):
        counts = torch.zeros(8, dtype=torch.int64)
        for seed in SEEDS:
            for step in range(N_STEPS):
                toks = sampling.sample_step(logits, cfg, seed, step, temp)
                counts += torch.bincount(toks.long(), minlength=8)
        assert counts[6:].sum() == 0
        want = torch.softmax(base[:6] / temp, dim=0)
        freq = counts[:6].double() / N_DRAWS
        assert float((freq - want.double()).abs().max()) < FREQ_ATOL, (
            temp, freq, want)


def test_counter_sampler_keys_and_greedy():
    """The noise depends on every counter (seed, step, row, id) and on
    nothing else: a step tensor and its int draw alike, rows of one step
    differ, and temperature 0 is the argmax."""
    cfg = types.SimpleNamespace(vocab_size=100)
    step = torch.tensor(9, dtype=torch.int64)
    n = sampling.step_noise(3, step, 4, 100)
    assert torch.equal(n, sampling.step_noise(3, torch.tensor(9), 4, 100))
    for other in (sampling.step_noise(4, step, 4, 100),
                  sampling.step_noise(3, step + 1, 4, 100)):
        assert not torch.equal(n, other)
    assert not torch.equal(n[0], n[1])
    assert torch.isfinite(n).all()
    logits = torch.randn(4, 128, generator=torch.Generator().manual_seed(0))
    assert torch.equal(sampling.sample_step(logits, cfg, 3, step),
                       sampling.sample_step(logits, cfg, 3, 9))
    assert torch.equal(sampling.sample_step(logits, cfg, 3, 9, 0.0),
                       logits[:, :100].argmax(-1).to(torch.int32))
