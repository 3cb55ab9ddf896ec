"""The decode paths of the newly served model families against the JAX
package's, on the CPU in fp32: ``decode_step`` on a dense cache,
``decode_step_paged`` and ``decode_loop_paged`` on the paged pool, each
embedding at the cache's ``pos`` or the state's ``lens`` (sinusoidal
positions go wrong on exactly these paths if a caller passes the wrong
ones).  Weights and tolerances as in ``test_torch_families.py``; greedy
tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense import _dense_caches
from test_torch_families import ARCHS, close, family_weights
from test_torch_model import _paged_state, _states

import repro.models as jm
from repro_torch import models as tm


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return family_weights(request.param)


def test_decode_step_matches_jax(pair):
    """Four greedy steps on a dense cache after a 60-token prefill:
    logits and caches after each step, and the tokens."""
    jcfg, jp, cfg, tp = pair
    first, *parts = _dense_caches(jcfg, jp, 60, 4, seed=23)
    jcache = jm.DecodeCache(*(None if a is None else jnp.asarray(a)
                              for a in parts))
    cache = tm.DecodeCache(*(None if a is None else torch.from_numpy(a.copy())
                             for a in parts))
    jtok, tok = jnp.asarray(first), torch.from_numpy(first)
    for _ in range(4):
        jlogits, jcache = jm.decode_step(jp, jcfg, jtok, jcache)
        logits, cache = tm.decode_step(tp, cfg, tok, cache)
        close(logits.numpy(), jlogits)
        close(cache.k.numpy(), jcache.k)
        close(cache.v.numpy(), jcache.v)
        jtok = jnp.argmax(jlogits[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_decode_step_paged_matches_jax(pair):
    jcfg, jp, cfg, tp = pair
    first, *pool = _paged_state(jcfg, jp, 70, 1, seed=2)
    jstate, tstate = _states(first, *pool)
    jlogits, jnew = jm.decode_step_paged(jp, jcfg, jnp.asarray(first),
                                         jstate, attn_impl="jnp")
    logits, new = tm.decode_step_paged(tp, cfg, torch.from_numpy(first),
                                       tstate)
    close(logits.numpy(), jlogits)
    close(new.k.numpy(), jnew.k)
    close(new.v.numpy(), jnew.v)
    np.testing.assert_array_equal(new.lens.numpy(), np.asarray(jnew.lens))


@pytest.mark.parametrize("horizon", [1, 8])
def test_decode_loop_paged_greedy_tokens_match_jax(pair, horizon):
    """Positions lens + i at step i of the horizon."""
    jcfg, jp, cfg, tp = pair
    first, *pool = _paged_state(jcfg, jp, 60, 8, seed=3)
    jstate, tstate = _states(first, *pool)
    want, jnew = jm.decode_loop_paged(jp, jcfg, jnp.asarray(first), jstate,
                                      jax.random.PRNGKey(0), 0, horizon,
                                      attn_impl="jnp")
    got, new = tm.decode_loop_paged(tp, cfg, torch.from_numpy(first),
                                    tstate, horizon)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    close(new.k.numpy(), jnew.k)
    np.testing.assert_array_equal(new.lens.numpy(), pool[3] + horizon)
