"""The port's model functions against the JAX package's, on the same weights.

JAX ``init_params`` of each smoke config goes through
``repro_torch.convert.from_jax_params``; both packages then see the same
numpy inputs.  fp32 on the CPU, where the port's kernels resolve to their
plain versions and JAX runs its exact jnp paths (``attn_impl="jnp"``).
Logits, K/V, SSM states and conv windows agree within ATOL = 1e-4 (the
same fp32 math in another order through a few layers; the SSD's chunked
scan sums in another order too); greedy tokens agree exactly.
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
ARCHS = ["yi-9b", "gemma2-2b", "mamba2-370m", "hymba-1.5b"]
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
    assert (cfg.padded_vocab(), cfg.q_dim, cfg.kv_dim, cfg.d_inner) == (
        jcfg.padded_vocab(), jcfg.q_dim, jcfg.kv_dim, jcfg.d_inner)


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
    logits, cache = tm.prefill(tp, cfg, torch.from_numpy(toks))
    _close(logits.numpy(), jlogits)
    for name in ("k", "v", "ssm", "conv"):
        want, got = getattr(jcache, name), getattr(cache, name)
        assert (got is None) == (want is None), name
        if want is not None:
            _close(got.numpy(), want)
    assert (cache.ssm is not None) == cfg.has_ssm
    assert (cache.k is not None) == cfg.has_attn


def _paged_state(jcfg, jp, prompt_len, horizon, seed):
    """Prefill two prompts with JAX and write their K/V (if the model has
    attention) into a numpy pool [L, P + 1, Hkv, PAGE, D] through a block
    table with room for ``horizon`` more tokens.  Returns (first tokens,
    pools, table, lens, SSM state, conv window); absent parts are None."""
    r = np.random.RandomState(seed)
    B = 2
    toks = r.randint(0, jcfg.vocab_size, (B, prompt_len)).astype(np.int32)
    logits, cache = jm.prefill(jp, jcfg, jnp.asarray(toks))
    S = prompt_len
    n = (S + horizon + PAGE - 1) // PAGE
    P = B * n + 3
    table = r.permutation(P)[:B * n].reshape(B, n).astype(np.int32)
    kp = vp = ssm = conv = None
    if cache.k is not None:
        k, v = np.asarray(cache.k), np.asarray(cache.v)
        L, _, _, Hkv, D = k.shape
        kp = np.zeros((L, P + 1, Hkv, PAGE, D), np.float32)
        vp = np.zeros_like(kp)
        for b in range(B):
            for t in range(S):
                kp[:, table[b, t // PAGE], :, t % PAGE] = k[:, b, t]
                vp[:, table[b, t // PAGE], :, t % PAGE] = v[:, b, t]
    if cache.ssm is not None:
        ssm, conv = np.asarray(cache.ssm), np.asarray(cache.conv)
    first = np.array(jnp.argmax(logits[:, :jcfg.vocab_size], -1),
                     np.int32)
    return first, kp, vp, table, np.full(B, S, np.int32), ssm, conv


def _states(first, kp, vp, table, lens, ssm, conv):
    jstate = jm.PagedDecodeState(*(None if a is None else jnp.asarray(a)
                                   for a in (kp, vp, table, lens, ssm,
                                             conv)))
    tstate = tm.PagedDecodeState(*(None if a is None
                                   else torch.from_numpy(a.copy())
                                   for a in (kp, vp, table, lens, ssm,
                                             conv)))
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
    # the port wrote the new K/V token and SSM rows in place
    for name in ("k", "v", "ssm", "conv"):
        got = getattr(new, name)
        assert got is getattr(tstate, name), name
        if got is not None:
            _close(got.numpy(), getattr(jnew, name))
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
    np.testing.assert_array_equal(new.lens.numpy(), pool[3] + horizon)


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.init_params(moe, device="cpu")
