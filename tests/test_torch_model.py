"""The port's model functions against the JAX package's, on the same weights.

JAX ``init_params`` of each smoke config goes through
``repro_torch.convert.from_jax_params``; both packages then see the same
numpy inputs.  fp32 on the CPU, where the port's kernels resolve to their
plain versions and JAX runs its exact jnp paths (``attn_impl="jnp"``).
Logits and K/V agree within ATOL = 1e-4 (the same fp32 math in another
order through a few layers); greedy tokens agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_smoke_config as jax_smoke_config
from repro_torch import models as tm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params

ATOL = 1e-4
ARCHS = ["yi-9b", "gemma2-2b"]
PAGE = 8


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX cfg, JAX params, port cfg, port params) for one arch."""
    jcfg = jax_smoke_config(request.param)
    cfg = get_smoke_config(request.param)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=0)


def test_config_copy_matches_jax(pair):
    jcfg, _, cfg, _ = pair
    for f in type(cfg).__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.padded_vocab(), cfg.q_dim, cfg.kv_dim) == (
        jcfg.padded_vocab(), jcfg.q_dim, jcfg.kv_dim)


def test_converted_params_are_exact(pair):
    _, jp, cfg, tp = pair
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree.leaves(tp))
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_init_params_has_jax_layout(pair):
    """The port's own init (used on the card, where there is no JAX) makes
    the JAX package's keys, shapes and dtype."""
    _, jp, cfg, _ = pair
    own = tm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    want = {jax.tree_util.keystr(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_leaves_with_path(jp)}
    got = {jax.tree_util.keystr(p): tuple(x.shape)
           for p, x in jax.tree_util.tree_leaves_with_path(own)}
    assert got == want
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves(own))


def test_forward_matches_jax(pair):
    jcfg, jp, cfg, tp = pair
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 20))
    toks = toks.astype(np.int32)
    want = jm.forward(jp, jcfg, jnp.asarray(toks))
    got = tm.forward(tp, cfg, torch.from_numpy(toks))
    _close(got.numpy(), want)


def test_prefill_matches_jax(pair):
    jcfg, jp, cfg, tp = pair
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 70))
    toks = toks.astype(np.int32)
    jlogits, jcache = jm.prefill(jp, jcfg, jnp.asarray(toks))
    logits, k, v = tm.prefill(tp, cfg, torch.from_numpy(toks))
    _close(logits.numpy(), jlogits)
    _close(k.numpy(), jcache.k)
    _close(v.numpy(), jcache.v)


def _paged_state(jcfg, jp, prompt_len, horizon, seed):
    """Prefill two prompts with JAX and write their K/V into a numpy pool
    [L, P + 1, Hkv, PAGE, D] through a block table with room for
    ``horizon`` more tokens.  Returns (first tokens, pools, table, lens)."""
    r = np.random.RandomState(seed)
    B = 2
    toks = r.randint(0, jcfg.vocab_size, (B, prompt_len)).astype(np.int32)
    logits, cache = jm.prefill(jp, jcfg, jnp.asarray(toks))
    k, v = np.asarray(cache.k), np.asarray(cache.v)
    L, _, S, Hkv, D = k.shape
    n = (S + horizon + PAGE - 1) // PAGE
    P = B * n + 3
    table = r.permutation(P)[:B * n].reshape(B, n).astype(np.int32)
    kp = np.zeros((L, P + 1, Hkv, PAGE, D), np.float32)
    vp = np.zeros_like(kp)
    for b in range(B):
        for t in range(S):
            kp[:, table[b, t // PAGE], :, t % PAGE] = k[:, b, t]
            vp[:, table[b, t // PAGE], :, t % PAGE] = v[:, b, t]
    first = np.array(jnp.argmax(logits[:, :jcfg.vocab_size], -1),
                     np.int32)
    return first, kp, vp, table, np.full(B, S, np.int32)


def _states(first, kp, vp, table, lens):
    jstate = jm.PagedDecodeState(jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(table), jnp.asarray(lens),
                                 None, None)
    tstate = tm.PagedDecodeState(*(torch.from_numpy(a.copy())
                                   for a in (kp, vp, table, lens)))
    return jstate, tstate


def test_decode_step_paged_matches_jax(pair):
    jcfg, jp, cfg, tp = pair
    first, *pool = _paged_state(jcfg, jp, 70, 1, seed=2)
    jstate, tstate = _states(first, *pool)
    jlogits, jnew = jm.decode_step_paged(jp, jcfg, jnp.asarray(first),
                                         jstate, attn_impl="jnp")
    logits, new = tm.decode_step_paged(tp, cfg, torch.from_numpy(first),
                                       tstate)
    _close(logits.numpy(), jlogits)
    # the port wrote the new token's K/V into the pool in place
    assert new.k is tstate.k
    _close(new.k.numpy(), jnew.k)
    _close(new.v.numpy(), jnew.v)
    np.testing.assert_array_equal(new.lens.numpy(), np.asarray(jnew.lens))


@pytest.mark.parametrize("horizon", [1, 4, 8])
def test_decode_loop_paged_greedy_tokens_match_jax(pair, horizon):
    jcfg, jp, cfg, tp = pair
    # 60 + 8 tokens cross gemma2-smoke's 64-token local window
    first, *pool = _paged_state(jcfg, jp, 60, 8, seed=3)
    jstate, tstate = _states(first, *pool)
    want, _ = jm.decode_loop_paged(jp, jcfg, jnp.asarray(first), jstate,
                                   jax.random.PRNGKey(0), 0, horizon,
                                   attn_impl="jnp")
    got, new = tm.decode_loop_paged(tp, cfg, torch.from_numpy(first),
                                    tstate, horizon)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(new.lens.numpy(), pool[-1] + horizon)


def test_sampled_stream_is_horizon_invariant(pair):
    """Sampled decoding draws from one generator per global step, so the
    stream is the same whether it runs as 8 steps of 1 or 1 horizon of 8."""
    jcfg, jp, cfg, tp = pair
    first, *pool = _paged_state(jcfg, jp, 20, 8, seed=4)
    _, one = _states(first, *pool)
    _, fused = _states(first, *pool)
    toks, steps = torch.from_numpy(first), []
    for i in range(8):
        toks, one = tm.decode_loop_paged(tp, cfg, toks, one, 1,
                                         temperature=1.0, seed=7, step0=i)
        steps.append(toks)
        toks = toks[:, 0]
    got, _ = tm.decode_loop_paged(tp, cfg, torch.from_numpy(first), fused, 8,
                                  temperature=1.0, seed=7)
    assert torch.equal(torch.cat(steps, dim=1), got)


def test_unported_families_raise():
    from repro_torch.models.config import ModelConfig
    moe = ModelConfig("m", "moe", 2, 64, 4, 2, 32, 128, 256, n_experts=4,
                      top_k=2)
    ssm = ModelConfig("s", "ssm", 2, 64, 4, 2, 32, 0, 256, ssm_state=16)
    for cfg in (moe, ssm):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tm.init_params(cfg, device="cpu")
