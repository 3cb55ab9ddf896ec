"""Why the SSD chunk kernel multiplies in 3xTF32, on the CPU.

The kernel (``csrc/ssd_chunk.cu``) runs its three products, C.B^T,
scores @ x and the state's (w x)^T B, on the tensor cores with TF32
operands.  A TF32 operand keeps 10 mantissa bits (``cvt.rna.tf32.f32``:
round to nearest, ties away from zero).  This file repeats the kernel's
data flow in numpy with its operands rounded that way and holds the result
against the plain version in float64 (``ref.ssd_chunk_plain``) at the
served models' shapes: one TF32 pass misses the 1e-4 of each output row's
largest value that the card check holds the kernel to, and 3xTF32 (each
operand split into hi = tf32(a) and lo = tf32(a - hi), the product summed
as hi.hi + hi.lo + lo.hi) meets it with room to spare.  Inputs are drawn
as the card check draws them (``ssd_inputs``), from a fixed seed.
"""
import numpy as np
import pytest
import torch
from test_torch_kernels_gpu import ROW_RTOL_SSD, ssd_inputs

from repro_torch.kernels import ref


def tf32(a):
    """fp32 values rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds them."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mm(a, b, passes):
    """a @ b with TF32 operands: one pass, or 3xTF32; products summed in
    float64, then rounded to the fp32 the kernel accumulates in."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ah, bh = tf32(a), tf32(b)
    out = ah.astype(np.float64) @ bh.astype(np.float64)
    if passes == 3:
        al, bl = tf32(a - ah), tf32(b - bh)
        out += (ah.astype(np.float64) @ bl.astype(np.float64)
                + al.astype(np.float64) @ bh.astype(np.float64))
    return out.astype(np.float32)


def emulate_kernel(x, dt, A, Bm, Cm, passes):
    """The kernel's data flow for one chunk with G = 1: C.B^T once, each
    head's scores = C.B^T * exp(cs_t - cs_s) * dt_s (causal) in fp32, then
    y = scores @ x and S = (x * w)^T B with w_s = exp(cs_end - cs_s) dt_s.
    x [Q, H, P], dt [Q, H], A [H], B/C [Q, N] -> y [Q, H, P], S [H, P, N].
    """
    Q = x.shape[0]
    cs = np.cumsum(dt * A[None, :], axis=0, dtype=np.float32)     # [Q, H]
    cb = mm(Cm, Bm.T, passes)                                      # [Q, Q]
    causal = np.tril(np.ones((Q, Q), bool))
    decay = np.exp(cs.T[:, :, None] - cs.T[:, None, :])           # [H, t, s]
    scores = np.where(causal, cb[None] * decay * dt.T[:, None, :], 0)
    y = mm(scores.astype(np.float32), x.transpose(1, 0, 2), passes)
    w = np.exp(cs[-1][None, :] - cs) * dt                          # [Q, H]
    xw = (x * w[:, :, None]).transpose(1, 2, 0)                    # [H, P, Q]
    S = mm(xw.astype(np.float32), Bm, passes)                      # [H, P, N]
    return y.transpose(1, 0, 2), S


def row_rel(got, want):
    """Largest |got - want| of a row (the last axis) over the row's
    largest |want|."""
    err = np.abs(got - want).max(-1)
    return float((err / np.maximum(np.abs(want).max(-1), 1e-30)).max())


# name, H, P, N: the served models' SSM shapes, one chunk of Q = 256
SHAPES = [("mamba2-370m", 32, 64, 128), ("hymba-1.5b", 25, 64, 16)]


@pytest.fixture(scope="module")
def errors():
    """{(shape, passes): (y error, S error)} against float64."""
    out = {}
    for name, H, P, N in SHAPES:
        x, dt, A, Bm, Cm = ssd_inputs(51, 1, 1, 256, H, P, N, 1)
        y64, S64 = ref.ssd_chunk_plain(
            *(torch.from_numpy(t).double() for t in (x, dt, A, Bm, Cm)))
        for passes in (1, 3):
            y, S = emulate_kernel(x[0, 0], dt[0, 0], A, Bm[0, 0, :, 0],
                                  Cm[0, 0, :, 0], passes)
            out[name, passes] = (row_rel(y, y64[0, 0].numpy()),
                                 row_rel(S, S64[0, 0].numpy()))
    return out


@pytest.mark.parametrize("name", [s[0] for s in SHAPES])
def test_3xtf32_meets_the_ssd_limit(errors, name):
    y_err, S_err = errors[name, 3]
    assert y_err <= ROW_RTOL_SSD / 10 and S_err <= ROW_RTOL_SSD / 10, (
        y_err, S_err)


@pytest.mark.parametrize("name", [s[0] for s in SHAPES])
def test_one_tf32_pass_misses_the_ssd_limit(errors, name):
    y_err, S_err = errors[name, 1]
    assert y_err > ROW_RTOL_SSD and S_err > ROW_RTOL_SSD, (y_err, S_err)


def test_the_emulated_data_flow_is_the_plain_versions_function():
    """Without rounding the operands (float64 products) the emulation is
    the plain version's function: the errors above are the rounding's."""
    x, dt, A, Bm, Cm = ssd_inputs(52, 1, 1, 100, 4, 16, 8, 1)
    y64, S64 = ref.ssd_chunk_plain(
        *(torch.from_numpy(t).double() for t in (x, dt, A, Bm, Cm)))
    x0, d0, b0, c0 = (t.astype(np.float64) for t in (
        x[0, 0], dt[0, 0], Bm[0, 0, :, 0], Cm[0, 0, :, 0]))
    Q = x0.shape[0]
    cs = np.cumsum(d0 * A[None, :], axis=0)
    decay = np.exp(cs.T[:, :, None] - cs.T[:, None, :])
    scores = np.where(np.tril(np.ones((Q, Q), bool)),
                      (c0 @ b0.T)[None] * decay * d0.T[:, None, :], 0)
    y = (scores @ x0.transpose(1, 0, 2)).transpose(1, 0, 2)
    w = np.exp(cs[-1][None, :] - cs) * d0
    S = (x0 * w[:, :, None]).transpose(1, 2, 0) @ b0
    assert row_rel(y, y64[0, 0].numpy()) < 1e-12
    assert row_rel(S, S64[0, 0].numpy()) < 1e-12


@pytest.mark.parametrize("value,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),        # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                      # below half: down
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),     # above half: up
    (2.0 - 2.0 ** -11, 2.0),                      # a tie into the next binade
])
def test_tf32_rounding_is_to_nearest_ties_away(value, want):
    assert tf32(np.float32(value)) == np.float32(want)


def test_3xtf32_split_is_exact_to_the_dropped_term():
    """hi + lo carries a value to within its last ~2^-21 relative."""
    a = np.random.RandomState(53).randn(4096).astype(np.float32)
    hi = tf32(a)
    lo = tf32(a - hi)
    rel = np.abs((hi.astype(np.float64) + lo) - a) / np.abs(a)
    assert rel.max() <= 2.0 ** -21
    assert np.abs(hi - a).max() > 0         # one TF32 does lose bits
