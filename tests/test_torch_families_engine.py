"""Greedy streams of the newly served model families through the port's
``ServingEngine`` against the JAX package's, token for token, in every
engine mode: paged decode at horizons 1 and 8, the dense mode, chunked
prefill and the prefix cache.  opt-30b (sinusoidal positions, biases,
GELU) and musicgen-medium (sinusoidal, the audio arch served from
codebook ids), on the perturbed smoke weights of
``test_torch_families.py``, fp32 on the CPU.  olmoe-1b-7b (MoE, qk-norm)
is in ``test_torch_families_engine_moe.py``.
"""
import numpy as np
import pytest
import torch
from test_torch_engine import _counters
from test_torch_families import family_weights

from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.serving.engine import ServingEngine

ARCHS = ["opt-30b", "musicgen-medium"]
MODES = {
    "H=1": dict(decode_horizon=1),
    "H=8": dict(decode_horizon=8),
    "dense": dict(decode_mode="dense"),
    "chunked": dict(decode_horizon=8, prefill_chunk_tokens=8),
    "prefix": dict(decode_horizon=8, prefix_cache=True),
}
ENGINE_KW = dict(num_blocks=64, block_size=8, max_seqs=4)
NEW_TOKENS = 6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _job(engine, vocab):
    """Five prompts of a 16-token template and a unique 4-12-token tail:
    request 0 alone to its first token (its pages are published), then
    the rest."""
    rng = np.random.RandomState(5)
    template = rng.randint(0, vocab, 16)
    prompts = [np.concatenate([template, rng.randint(0, vocab, n)])
               .astype(np.int32) for n in (4, 12, 7, 9, 5)]
    engine.submit(0, prompts[0], NEW_TOKENS)
    done = {r.rid: list(r.generated) for r in engine.step()}
    for rid, p in enumerate(prompts[1:], 1):
        engine.submit(rid, p, NEW_TOKENS)
    done.update({r.rid: list(r.generated)
                 for r in engine.run_to_completion()})
    return done


@pytest.fixture(scope="module")
def streams():
    """{(arch, mode): the port's streams}, filled as the cases run."""
    return {}


def check_streams(arch, mode, streams):
    """One arch and mode through both engines: streams, counters and
    ``load_stats()`` equal; the streams also equal the arch's other
    modes' in ``streams``."""
    jcfg, jp, cfg, tp = family_weights(arch)
    kw = dict(ENGINE_KW, **MODES[mode])
    jeng = JaxEngine(jcfg, jp, **kw)
    eng = ServingEngine(cfg, tp, device="cpu", **kw)
    want, got = _job(jeng, jcfg.vocab_size), _job(eng, cfg.vocab_size)
    assert got == want
    assert sorted(got) == list(range(5))
    assert all(len(t) == NEW_TOKENS for t in got.values())
    assert _counters(eng) == _counters(jeng)
    assert eng.load_stats() == jeng.load_stats()
    if mode == "prefix":
        assert eng.load_stats()["prefix_hits"] == 4
    if mode == "chunked":
        assert eng.prefill_tokens == sum(
            16 + n for n in (4, 12, 7, 9, 5))
    # greedy tokens do not depend on the mode
    streams[arch, mode] = got
    assert all(s == got for (a, _), s in streams.items() if a == arch)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_jax(arch, mode, streams):
    check_streams(arch, mode, streams)
