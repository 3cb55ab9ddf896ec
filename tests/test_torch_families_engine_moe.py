"""The MoE family's greedy streams through the port's ``ServingEngine``
against the JAX package's in every engine mode (olmoe-1b-7b: MoE and
qk-norm; the modes, job and checks of ``test_torch_families_engine.py``),
and the twin of the JAX package's
``tests/test_serving.py::test_engine_token_exact_vs_reference`` (olmoe on
JAX's own init): the engine's streams equal a plain prefill and
``decode_step`` loop's, JAX's and the port's.  fp32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families_engine import MODES, check_streams

import repro.models as jm
from repro.configs import get_smoke_config as jax_smoke_config
from repro_torch import models as tm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.serving.engine import ServingEngine


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def streams():
    """{(arch, mode): the port's streams}, filled as the cases run."""
    return {}


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_engine_streams_match_jax(mode, streams):
    check_streams("olmoe-1b-7b", mode, streams)


def test_engine_token_exact_vs_reference():
    """The twin of the JAX package's test: olmoe smoke on JAX's own init
    (no perturbation), three requests over two slots; the port's engine
    gives JAX's plain prefill + ``decode_step`` tokens."""
    jcfg = jax_smoke_config("olmoe-1b-7b")
    cfg = get_smoke_config("olmoe-1b-7b")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (10, 10, 14)]
    news = [5, 3, 6]

    def ref_gen(prompt, n_new):
        lp, cache = jm.prefill(jp, jcfg, jnp.asarray(prompt)[None])
        big = jm.init_cache(jcfg, 1, len(prompt) + n_new + 2, jnp.float32)
        big.k = big.k.at[:, :, :len(prompt)].set(cache.k)
        big.v = big.v.at[:, :, :len(prompt)].set(cache.v)
        big.pos = cache.pos
        toks = [int(jnp.argmax(lp[0, :jcfg.vocab_size]))]
        for _ in range(n_new - 1):
            lg, big = jm.decode_step(jp, jcfg,
                                     jnp.asarray([toks[-1]], jnp.int32), big)
            toks.append(int(jnp.argmax(lg[0, :jcfg.vocab_size])))
        return toks

    eng = ServingEngine(cfg, tp, num_blocks=64, block_size=8, max_seqs=2,
                        device="cpu")
    for i, (p, n) in enumerate(zip(prompts, news)):
        eng.submit(i, p, n)
    done = {r.rid: r.generated for r in eng.run_to_completion()}
    for i, (p, n) in enumerate(zip(prompts, news)):
        assert done[i] == ref_gen(p, n)
        # and the port's own plain loop gives them too
        logits, cache = tm.prefill(tp, cfg, torch.from_numpy(p)[None])
        k = torch.zeros(cfg.n_layers, 1, len(p) + n, cfg.n_kv_heads,
                        cfg.head_dim)
        v = torch.zeros_like(k)
        k[:, :, :len(p)], v[:, :, :len(p)] = cache.k, cache.v
        dc = tm.DecodeCache(k, v, None, None,
                            torch.tensor([len(p)], dtype=torch.int32))
        toks = [int(logits[0, :cfg.vocab_size].argmax())]
        for _ in range(n - 1):
            logits, dc = tm.decode_step(
                tp, cfg, torch.tensor([toks[-1]], dtype=torch.int32), dc)
            toks.append(int(logits[0, :cfg.vocab_size].argmax()))
        assert done[i] == toks
