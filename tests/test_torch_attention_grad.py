"""The gradient of the prefill attention on the CPU.

``ref.flash_attention_bwd_plain``, the plain version of the backward kernel
(its formulas written out), against autograd of ``flash_attention_ref``
within 1e-5 (fp32 sums in another order), for groups of 1, 2 and 4, a
window, a softcap and ragged lengths; the port's attention layer under
autograd against ``jax.grad`` of the JAX package's ``full_attention`` on
one layer's weights within 1e-4 of each gradient's largest value, also past
2048 tokens, where JAX takes its query-chunked, rematted branch; and the
guard that keeps the kernels without a backward off the training path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import perturbed

import repro.models as jm
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn

ATOL = 1e-5
LAYER_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BWD_CASES = [
    # name, B, S, Hq, Hkv, D, softcap, window
    ("group1", 2, 33, 4, 4, 16, 0.0, 0),
    ("group2-ragged", 2, 45, 4, 2, 32, 0.0, 0),
    ("group4-window", 1, 70, 8, 2, 16, 0.0, 20),
    ("softcap", 2, 40, 4, 2, 32, 30.0, 0),
    ("softcap-window-ragged", 1, 77, 8, 2, 32, 50.0, 25),
]


@pytest.mark.parametrize("name,B,S,Hq,Hkv,D,cap,win", BWD_CASES,
                         ids=[c[0] for c in BWD_CASES])
def test_plain_backward_matches_autograd(name, B, S, Hq, Hkv, D, cap, win):
    r = np.random.RandomState(S)
    q, k, v = (torch.from_numpy((r.randn(B, S, h, D) * 0.5)
                                .astype(np.float32)).requires_grad_(True)
               for h in (Hq, Hkv, Hkv))
    dout = torch.from_numpy(r.randn(B, S, Hq, D).astype(np.float32))
    out = ref.flash_attention_ref(q, k, v, softcap=cap, window=win)
    out.backward(dout)
    lse = ref.flash_attention_lse_ref(q.detach(), k.detach(), softcap=cap,
                                      window=win)
    got = ref.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                        out.detach(), dout, lse, True, cap,
                                        win)
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == t.shape
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=ATOL,
                                   rtol=0)


def test_lse_is_the_log_of_the_softmax_denominator():
    """exp(s - lse) sums to 1 over each row's unmasked keys."""
    r = np.random.RandomState(0)
    q = torch.from_numpy(r.randn(1, 50, 4, 16).astype(np.float32))
    k = torch.from_numpy(r.randn(1, 50, 2, 16).astype(np.float32))
    lse = ref.flash_attention_lse_ref(q, k, softcap=20.0, window=9)
    s, _, ok = ref._scores(q, k, True, 20.0, 9, 0)
    total = torch.where(ok, torch.exp(s - lse[..., None]), 0.0).sum(-1)
    np.testing.assert_allclose(total.numpy(), 1.0, atol=1e-6)


def _layer(arch, seed, **changes):
    """(JAX cfg, JAX attention weights, port cfg, port weights) of one
    layer of ``arch``'s smoke config, fp32, zero leaves perturbed."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), **changes)
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    np_tree = perturbed(jax.tree.map(np.asarray, jp), seed=seed + 1)
    tp = from_jax_params(np_tree, cfg, "cpu")
    layer = jax.tree.map(lambda x: jnp.asarray(x[0]),
                         np_tree["blocks"]["attn"])
    return jcfg, layer, cfg, {k: v[0] for k, v in
                              tp["blocks"]["attn"].items()}


# arch, S, local layer: the dense layer, gemma2's local layer past its
# window with its softcap, qk-norm with a bias, and past 2048 tokens
LAYER_CASES = [("yi-9b", 96, False), ("gemma2-2b", 150, True),
               ("qwen1.5-110b", 64, False), ("yi-9b", 3072, False)]


@pytest.mark.parametrize("arch,S,local", LAYER_CASES,
                         ids=[f"{a}-{s}" for a, s, _ in LAYER_CASES])
def test_attention_layer_grad_matches_jax(arch, S, local):
    changes = dict(n_q_heads=2, n_kv_heads=1) if S > 2048 else {}
    jcfg, jp, cfg, tp = _layer(arch, 3, **changes)
    assert S <= jattn.CHUNK_THRESHOLD or S % jattn.Q_CHUNK == 0
    r = np.random.RandomState(1)
    x = (r.randn(1, S, cfg.d_model) * 0.5).astype(np.float32)
    ct = r.randn(1, S, cfg.d_model).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]

    def jloss(p, x):
        out = jattn.full_attention(x, p, jcfg, jnp.asarray(pos), local)
        return jnp.sum(out * ct)

    jval, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _, _ = tattn.full_attention(tx, live, cfg, torch.from_numpy(pos),
                                     local)
    val = (out * torch.from_numpy(ct)).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    pairs = [("x", tx.grad, jgx)] + [(k, live[k].grad, jgp[k])
                                     for k in sorted(live)]
    assert sorted(live) == sorted(jgp)
    for name, g, w in pairs:
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= LAYER_RTOL, (name, err)


def test_grad_guard_raises_only_where_a_gradient_is_needed():
    """The condition under which the CUDA branches of the kernels without
    a backward (the decode kernels B1, B3) raise: grad mode on and an
    input requiring grad."""
    x = torch.zeros(3, requires_grad=True)
    y = torch.zeros(3)
    with pytest.raises(RuntimeError, match="paged_decode: the CUDA kernel "
                       "has no backward"):
        ops.grad_guard("paged_decode", y, x)
    ops.grad_guard("paged_decode", y, y)        # serving: nothing needs grad
    with torch.no_grad():
        ops.grad_guard("paged_decode", x, y)    # or grad mode is off
    with pytest.raises(RuntimeError, match="flash_decode"):
        ops.grad_guard("flash_decode", x.detach().requires_grad_(True))


def test_ops_flash_attention_is_differentiable_on_the_cpu():
    """On the CPU ``ops.flash_attention`` is the plain version, which
    autograd differentiates; its gradient is the plain backward's."""
    r = np.random.RandomState(2)
    q = torch.from_numpy(r.randn(1, 20, 4, 8).astype(np.float32))
    k = torch.from_numpy(r.randn(1, 20, 2, 8).astype(np.float32))
    v = torch.from_numpy(r.randn(1, 20, 2, 8).astype(np.float32))
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*live, softcap=10.0, window=7)
    dout = torch.ones_like(out)
    out.backward(dout)
    lse = ref.flash_attention_lse_ref(q, k, softcap=10.0, window=7)
    want = ref.flash_attention_bwd_plain(q, k, v, out.detach(), dout, lse,
                                         True, 10.0, 7)
    for t, w in zip(live, want):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), atol=ATOL)
