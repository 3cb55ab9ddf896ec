"""The model families this port added to the dense and SSM ones (opt's
sinusoidal positions and biased GELU MLP, MoE with qk-norm, starcoder2's
biases, qwen's qkv bias, chameleon's qk-norm, musicgen's ``embeds``
input) against the JAX package, on the CPU in fp32.

Each arch's smoke config takes JAX ``init_params`` weights through
``convert.from_jax_params``, with every leaf JAX's init sets to zero
(biases, norm gains, qk-norm) drawn anew from a seed in both packages, so
the branches behind them change the result.  Logits and K/V agree within
ATOL = 1e-4 (the same fp32 math in another order through a few layers),
at positions below 512, where the two packages' sinusoidal embeddings
agree within SINCOS_ATOL = 1e-4 (above, within SINCOS_ATOL_FAR = 5e-4 up
to position 4096: fp32 ``sin``/``cos`` of angles up to 4096 rad round
differently in the two libraries).  The decode paths are in
``test_torch_families_decode.py``, the engine in
``test_torch_families_engine.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import _paged_state, _states

import repro.models as jm
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.layers import sincos_embedding as jax_sincos
from repro_torch import models as tm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.models.layers import sincos_embedding

ATOL = 1e-4
SINCOS_ATOL, SINCOS_ATOL_FAR = 1e-4, 5e-4
PAGE = 8
# the archs served since the model families were ported
ARCHS = ["opt-30b", "opt-66b", "olmoe-1b-7b", "granite-moe-3b-a800m",
         "starcoder2-3b", "qwen1.5-110b", "chameleon-34b", "musicgen-medium"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturbed(np_tree, seed: int):
    """``np_tree`` with every all-zero leaf (biases, norm gains, qk-norm:
    JAX's init sets them to zero) drawn from N(0, 0.1) instead."""
    rng = np.random.RandomState(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        a = np.asarray(t)
        if not a.any():
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return walk(np_tree)


@functools.lru_cache(maxsize=None)
def family_weights(arch, capacity_factor=None):
    """(JAX cfg, JAX params, port cfg, port params) of ``arch``'s smoke
    config, fp32, zero leaves perturbed; ``capacity_factor`` replaces the
    MoE one in both configs."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity_factor)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_tree = perturbed(jax.tree.map(np.asarray, jp), seed=7)
    return (jcfg, jax.tree.map(jnp.asarray, np_tree), cfg,
            from_jax_params(np_tree, cfg, "cpu"))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return family_weights(request.param)


def test_config_copy_matches_jax(pair):
    jcfg, _, cfg, _ = pair
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    name = cfg.name.removesuffix("-smoke")
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
        jax_config(name))


def test_every_zero_leaf_was_perturbed(pair):
    """The branches behind biases and norm gains are exercised: no leaf of
    the converted weights is all zero."""
    _, _, _, tp = pair
    assert all(leaf.any() for leaf in jax.tree.leaves(tp))


def test_init_params_has_jax_layout(pair):
    """The port's own init (the card's weights, where there is no JAX)
    makes the JAX package's keys and shapes, in the asked dtype but for
    the MoE router, which stays fp32 as in JAX."""
    _, jp, cfg, _ = pair
    own = tm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    want = {jax.tree_util.keystr(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_leaves_with_path(jp)}
    got = {jax.tree_util.keystr(p): (tuple(x.shape), x.dtype)
           for p, x in jax.tree_util.tree_leaves_with_path(own)}
    assert {k: shape for k, (shape, _) in got.items()} == want
    for key, (_, dtype) in got.items():
        router = key == "['blocks']['moe']['router']"
        assert dtype == (torch.float32 if router else torch.bfloat16), key


def test_forward_matches_jax(pair):
    jcfg, jp, cfg, tp = pair
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 20))
    toks = toks.astype(np.int32)
    close(tm.forward(tp, cfg, torch.from_numpy(toks)).numpy(),
          jm.forward(jp, jcfg, jnp.asarray(toks)))


def test_prefill_matches_jax(pair):
    jcfg, jp, cfg, tp = pair
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 70))
    toks = toks.astype(np.int32)
    jlogits, jcache = jm.prefill(jp, jcfg, jnp.asarray(toks))
    logits, cache = tm.prefill(tp, cfg, torch.from_numpy(toks))
    close(logits.numpy(), jlogits)
    close(cache.k.numpy(), jcache.k)
    close(cache.v.numpy(), jcache.v)


def test_prefill_chunk_at_an_offset_matches_jax(pair):
    """A 90-token prompt in chunks of 32, 32 and 26 (bucketed to 32): the
    later chunks embed and attend at ``start`` 32 and 64."""
    jcfg, jp, cfg, tp = pair
    r = np.random.RandomState(2)
    S, C = 90, 32
    toks = r.randint(0, cfg.vocab_size, (1, S)).astype(np.int32)
    n = (S + PAGE - 1) // PAGE
    P = n + 4
    table = r.permutation(P)[:n][None].astype(np.int32)
    shape = (cfg.n_layers, P + 1, cfg.n_kv_heads, PAGE, cfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    for start in range(0, S, C):
        n_valid = min(C, S - start)
        buf = np.zeros((1, C), np.int32)
        buf[0, :n_valid] = toks[0, start:start + n_valid]
        jlogits, jk, jv = jm.prefill_chunk(
            jp, jcfg, jnp.asarray(buf), jk, jv, jnp.asarray(table),
            jnp.int32(start), jnp.int32(n_valid), P)
        logits = tm.prefill_chunk(tp, cfg, torch.from_numpy(buf), tk, tv,
                                  torch.from_numpy(table), start, n_valid, P)
        close(logits.numpy(), jlogits)
    close(tk[:, :P].numpy(), np.asarray(jk)[:, :P])
    close(tv[:, :P].numpy(), np.asarray(jv)[:, :P])
    # and the chunks' last logits are the one-shot prefill's
    close(logits.numpy(), tm.prefill(tp, cfg, torch.from_numpy(toks))[0])


@pytest.mark.parametrize("d_model", [64, 1536, 7168])
def test_sincos_embedding_matches_jax(d_model):
    pos = np.arange(4096, dtype=np.int32)[None]
    want = np.asarray(jax_sincos(jnp.asarray(pos), d_model))
    got = sincos_embedding(torch.from_numpy(pos), d_model).numpy()
    assert got.dtype == np.float32 and got.shape == (1, 4096, d_model)
    close(got[:, :512], want[:, :512], SINCOS_ATOL)
    close(got, want, SINCOS_ATOL_FAR)


def test_musicgen_embeds_input_matches_jax():
    """The stub frontend's precomputed frame embeddings in place of ids:
    ``forward``, ``prefill``, ``decode_step`` and ``decode_step_paged``
    take ``embeds=``, and embedding ids through the table gives the ids'
    result."""
    jcfg, jp, cfg, tp = family_weights("musicgen-medium")
    r = np.random.RandomState(3)
    emb = (0.02 * r.standard_normal((2, 30, cfg.d_model))).astype(np.float32)
    close(tm.forward(tp, cfg, embeds=torch.from_numpy(emb)).numpy(),
          jm.forward(jp, jcfg, embeds=jnp.asarray(emb)))
    jlogits, jcache = jm.prefill(jp, jcfg, embeds=jnp.asarray(emb))
    logits, cache = tm.prefill(tp, cfg, embeds=torch.from_numpy(emb))
    close(logits.numpy(), jlogits)
    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    k, v = np.pad(cache.k.numpy(), pad), np.pad(cache.v.numpy(), pad)
    pos = np.full(2, 30, np.int32)
    jdc = jm.DecodeCache(jnp.asarray(k), jnp.asarray(v), None, None,
                         jnp.asarray(pos))
    dc = tm.DecodeCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                        None, None, torch.from_numpy(pos))
    for i in range(3):
        step = (0.02 * r.standard_normal((2, 1, cfg.d_model))).astype(
            np.float32)
        jlogits, jdc = jm.decode_step(jp, jcfg, None, jdc,
                                      embeds=jnp.asarray(step))
        logits, dc = tm.decode_step(tp, cfg, None, dc,
                                    embeds=torch.from_numpy(step))
        close(logits.numpy(), jlogits)
    close(dc.k.numpy(), jdc.k)
    # and one step on the paged pool
    first, *pool = _paged_state(jcfg, jp, 30, 1, seed=5)
    jstate, tstate = _states(first, *pool)
    step = (0.02 * r.standard_normal((2, 1, cfg.d_model))).astype(np.float32)
    jlogits, jnew = jm.decode_step_paged(jp, jcfg, None, jstate,
                                         embeds=jnp.asarray(step),
                                         attn_impl="jnp")
    logits, new = tm.decode_step_paged(tp, cfg, None, tstate,
                                       embeds=torch.from_numpy(step))
    close(logits.numpy(), jlogits)
    close(new.k.numpy(), jnew.k)
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, (2, 9)))
    close(tm.forward(tp, cfg, embeds=tp["embed"][toks]).numpy(),
          tm.forward(tp, cfg, toks).numpy())


def test_moe_capacity_path_inside_the_model_matches_jax():
    """olmoe smoke at B = 3, S = 1024 (3072 tokens: the capacity path)
    with capacity factor 1.0: the forward is JAX's, and it differs from
    the drop-free one, so tokens were dropped inside the model."""
    jcfg, jp, cfg, tp = family_weights("olmoe-1b-7b", 1.0)
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (3, 1024))
    toks = toks.astype(np.int32)
    got = tm.forward(tp, cfg, torch.from_numpy(toks))
    close(got.numpy(), jm.forward(jp, jcfg, jnp.asarray(toks)))
    free = tm.forward(tp, dataclasses.replace(cfg, moe_capacity_factor=8.0),
                      torch.from_numpy(toks))
    assert float((got - free).abs().max()) > 1e-2
