"""The gradient of the SSD chunk kernel on the CPU.

``ref.ssd_chunk_bwd_plain``, the plain version of the backward kernel (its
formulas written out), against ``jax.vjp`` of the JAX package's
within-chunk oracle ``ssd_chunk_ref`` (fp32, groups broadcast inside the
wrapped function) within 1e-5 of each gradient's largest |value|, and
against torch autograd of ``ssd_chunk_plain`` in float64 within 1e-10; and
the ``autograd.Function`` that ``ops.ssd_chunk`` uses on the card, its two
kernel calls replaced by their plain versions, inside the port's
``ssd_chunked`` against ``jax.vjp`` of the JAX package's ``ssd_chunked``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm as tssm

# fp32 JAX against the float64 plain version: dcs is a difference of two
# sums of ~Q terms, so ddt and dA carry ~1e-6 of their largest value
LEAF_RTOL = 1e-5
F64_ATOL = 1e-10
# ssd_chunked's gradients in fp32 on both sides (the port casts the state
# to fp32), through the cross-chunk recurrence as well
CHUNKED_RTOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chunk_inputs(seed, B, Nc, Q, H, P, N, G, zero_dS=False):
    """numpy x, dt (softplus's range at init), A < 0, per-group B/C, and
    the cotangents dy and dS."""
    r = np.random.RandomState(seed)
    x = (r.randn(B, Nc, Q, H, P) * 0.3).astype(np.float32)
    dt = (np.abs(r.randn(B, Nc, Q, H) * 0.3) + 0.01).astype(np.float32)
    A = (-np.abs(r.randn(H)) - 0.1).astype(np.float32)
    Bm = (r.randn(B, Nc, Q, G, N) * 0.5).astype(np.float32)
    Cm = (r.randn(B, Nc, Q, G, N) * 0.5).astype(np.float32)
    dy = r.randn(B, Nc, Q, H, P).astype(np.float32)
    dS = r.randn(B, Nc, H, P, N).astype(np.float32)
    if zero_dS:
        dS[:] = 0
    return x, dt, A, Bm, Cm, dy, dS


CASES = [
    # name, B, Nc, Q, H, P, N, G, dS = 0
    ("ragged-q13", 2, 2, 13, 4, 8, 6, 1, False),
    ("groups2", 1, 3, 16, 4, 4, 8, 2, False),
    ("ds-zero", 2, 1, 21, 3, 5, 4, 1, True),
]


def jax_chunk_vjp(x, dt, A, Bm, Cm, dy, dS):
    rep = x.shape[3] // Bm.shape[3]

    def f(x, dt, A, Bm, Cm):
        return jref.ssd_chunk_ref(x, dt, A, jnp.repeat(Bm, rep, axis=3),
                                  jnp.repeat(Cm, rep, axis=3))

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, dt, A, Bm, Cm)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dS)))]


@pytest.mark.parametrize("name,B,Nc,Q,H,P,N,G,zero_dS", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax_vjp(name, B, Nc, Q, H, P, N, G, zero_dS):
    arrays = chunk_inputs(3, B, Nc, Q, H, P, N, G, zero_dS)
    want = jax_chunk_vjp(*arrays)
    got = ref.ssd_chunk_bwd_plain(*(torch.from_numpy(a).double()
                                    for a in arrays))
    for label, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, label
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= LEAF_RTOL, (label, err)


@pytest.mark.parametrize("name,B,Nc,Q,H,P,N,G,zero_dS", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_backward_matches_autograd_float64(name, B, Nc, Q, H, P, N, G,
                                                 zero_dS):
    arrays = [torch.from_numpy(a).double()
              for a in chunk_inputs(4, B, Nc, Q, H, P, N, G, zero_dS)]
    live = [t.clone().requires_grad_(True) for t in arrays[:5]]
    y, S = ref.ssd_chunk_plain(*live)
    want = torch.autograd.grad((y, S), live, arrays[5:])
    got = ref.ssd_chunk_bwd_plain(*arrays)
    for label, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=F64_ATOL, err_msg=label)


CHUNKED_CASES = [
    # name, B, L, H, P, N, G, chunk, init_state, final state used
    ("chunks4-tail-init", 2, 50, 4, 8, 6, 2, 16, True, True),
    ("one-chunk-state-unused", 1, 20, 2, 4, 8, 1, 32, False, False),
]


@pytest.mark.parametrize("name,B,L,H,P,N,G,chunk,init,use_state",
                         CHUNKED_CASES, ids=[c[0] for c in CHUNKED_CASES])
def test_function_in_ssd_chunked_matches_jax_vjp(monkeypatch, name, B, L, H,
                                                 P, N, G, chunk, init,
                                                 use_state):
    """The card's wiring on the CPU: ``ops.ssd_chunk`` routed through
    ``_SSDChunk`` with the forward and backward kernels replaced by their
    plain versions (the backward counted), inside the port's
    ``ssd_chunked`` (chunks, a padded tail, an initial state; or one chunk
    whose final state is unused, so dS arrives as zeros)."""
    calls = []

    def bwd(*args):
        calls.append(args[-2].is_contiguous())
        return ref.ssd_chunk_bwd_plain(*args)

    monkeypatch.setattr(ops._ssd, "ssd_chunk", ref.ssd_chunk_plain)
    monkeypatch.setattr(ops._ssb, "ssd_chunk_bwd", bwd)
    monkeypatch.setattr(ops, "ssd_chunk",
                        lambda *a: ops._SSDChunk.apply(*a))
    r = np.random.RandomState(5)
    xs = (r.randn(B, L, H, P) * 0.3).astype(np.float32)
    dt = (np.abs(r.randn(B, L, H) * 0.3) + 0.01).astype(np.float32)
    A = (-np.abs(r.randn(H)) - 0.1).astype(np.float32)
    Bm = (r.randn(B, L, G, N) * 0.5).astype(np.float32)
    Cm = (r.randn(B, L, G, N) * 0.5).astype(np.float32)
    s0 = (r.randn(B, H, P, N) * 0.3).astype(np.float32)
    dy = r.randn(B, L, H, P).astype(np.float32)
    dstate = (r.randn(B, H, P, N) if use_state
              else np.zeros((B, H, P, N))).astype(np.float32)
    inputs = [xs, dt, A, Bm, Cm] + ([s0] if init else [])

    def jf(*a):
        return jssm.ssd_chunked(*a[:5], chunk,
                                init_state=a[5] if init else None)

    _, vjp = jax.vjp(jf, *map(jnp.asarray, inputs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    live = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    y, state = tssm.ssd_chunked(*live[:5], chunk,
                                init_state=live[5] if init else None)
    outs, cots = [y], [torch.from_numpy(dy)]
    if use_state:
        outs.append(state)
        cots.append(torch.from_numpy(dstate))
    torch.autograd.backward(outs, cots)
    assert calls == [True]
    for i, (t, w) in enumerate(zip(live, want)):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max() / np.abs(w).max()
        assert err <= CHUNKED_RTOL, (i, err)


def test_kernel_inputs_are_fp32_and_contiguous_in_bf16_training(monkeypatch):
    """bf16 compute casts every leaf of two or more dims, so the
    layer-stacked ``A_log`` [L, H] too (as the JAX package's
    ``cast_for_compute`` does); ``ssd_chunked`` still hands the SSD chunk
    kernel fp32, contiguous x, dt, A, B and C, the only inputs its CUDA
    wrapper takes."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, packed_batches
    from repro_torch.train.trainer import (TrainConfig, batch_to_device,
                                           init_train_state, value_and_grad)
    seen = []
    plain = ops.ssd_chunk

    def spy(*args):
        seen.append([(t.dtype, t.is_contiguous()) for t in args])
        return plain(*args)

    monkeypatch.setattr(ops, "ssd_chunk", spy)
    cfg = get_smoke_config("hymba-1.5b")
    tcfg = TrainConfig(remat=False, compute_dtype=torch.bfloat16)
    state = init_train_state(cfg, 0, tcfg, "cpu")
    batch = next(packed_batches(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=40, batch_size=1)))
    value_and_grad(state["params"], cfg, batch_to_device(batch, "cpu"), tcfg)
    assert len(seen) == cfg.n_layers
    assert all(args == [(torch.float32, True)] * 5 for args in seen), seen
