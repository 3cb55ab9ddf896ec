"""The port's SSD mixer (``repro_torch.models.ssm``) against the JAX
package's, on the same numpy inputs and weights.

fp32 on the CPU, where ``ops.ssd_chunk`` resolves to the kernel's plain
version.  The chunked scan agrees with JAX's chunked scan within
ATOL = 1e-4 (the same fp32 math; the cross-chunk loop and the
associative scan sum in another order), and with the token-by-token
recurrence within RECURRENT_ATOL = 1e-3 (the chunked and recurrent forms
are different orders of a few hundred exp-weighted sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import ssm as jssm
from repro_torch import models as tm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ref
from repro_torch.models import ssm as tssm
from repro_torch.models.model import layer_params

ATOL = 1e-4
RECURRENT_ATOL = 1e-3


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def _scan_inputs(seed, B, L, H, P, N, G, with_state):
    r = np.random.RandomState(seed)
    xs = (r.randn(B, L, H, P) * 0.3).astype(np.float32)
    dt = (np.abs(r.randn(B, L, H) * 0.05) + 0.01).astype(np.float32)
    A = (-np.abs(r.randn(H))).astype(np.float32)
    Bm = (r.randn(B, L, G, N) * 0.3).astype(np.float32)
    Cm = (r.randn(B, L, G, N) * 0.3).astype(np.float32)
    s0 = ((r.randn(B, H, P, N) * 0.3).astype(np.float32) if with_state
          else None)
    return xs, dt, A, Bm, Cm, s0


SCAN_CASES = [
    # B, L, H, P, N, G, chunk, initial state
    (1, 100, 4, 16, 16, 1, 64, False),   # ragged: padded to 128, Nc = 2
    (2, 150, 8, 32, 16, 2, 64, True),    # groups, Nc = 3, initial state
    (1, 37, 2, 16, 8, 1, 64, False),     # one short chunk: Q = L
    (1, 256, 4, 64, 128, 1, 128, True),  # mamba2's P and N
]


@pytest.mark.parametrize("B,L,H,P,N,G,chunk,with_state", SCAN_CASES)
def test_ssd_chunked_matches_jax_and_recurrence(B, L, H, P, N, G, chunk,
                                                with_state):
    xs, dt, A, Bm, Cm, s0 = _scan_inputs(20, B, L, H, P, N, G, with_state)
    t_in = [torch.from_numpy(a) for a in (xs, dt, A, Bm, Cm)]
    t_s0 = None if s0 is None else torch.from_numpy(s0)
    j_in = [jnp.asarray(a) for a in (xs, dt, A, Bm, Cm)]
    j_s0 = None if s0 is None else jnp.asarray(s0)
    y, state = tssm.ssd_chunked(*t_in, chunk, t_s0)
    assert y.shape == (B, L, H, P) and state.shape == (B, H, P, N)
    jy, jstate = jssm.ssd_chunked(*j_in, chunk, j_s0)
    _close(y.numpy(), jy)
    _close(state.numpy(), jstate)
    # against the token-by-token recurrence, JAX's and the port's copy
    ry, rstate = jssm.ssd_reference(*j_in, init_state=j_s0)
    _close(y.numpy(), ry, RECURRENT_ATOL)
    _close(state.numpy(), rstate, RECURRENT_ATOL)
    ty, tstate = ref.ssd_reference(*t_in, init_state=t_s0)
    _close(ty.numpy(), ry)
    _close(tstate.numpy(), rstate)


@pytest.fixture(scope="module", params=["mamba2-370m", "hymba-1.5b"])
def layer(request):
    """(JAX cfg, JAX layer-0 SSM params, port cfg, port layer-0 params)."""
    jcfg = jax_smoke_config(request.param)
    cfg = get_smoke_config(request.param)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"])
    return jcfg, jl, cfg, layer_params(tp["blocks"], 0)["ssm"]


def test_ssm_forward_with_carried_state_matches_jax(layer):
    """A prompt continued from an earlier SSM state and conv window."""
    jcfg, jl, cfg, tl = layer
    r = np.random.RandomState(21)
    x = (r.randn(2, 70, cfg.d_model) * 0.5).astype(np.float32)
    s0 = (r.randn(2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
          * 0.3).astype(np.float32)
    c0 = (r.randn(2, cfg.ssm_conv_width - 1, tssm.conv_channels(cfg))
          * 0.3).astype(np.float32)
    want = jssm.ssm_forward(jnp.asarray(x), jl, jcfg, jnp.asarray(s0),
                            jnp.asarray(c0))
    got = tssm.ssm_forward(torch.from_numpy(x), tl, cfg,
                           torch.from_numpy(s0), torch.from_numpy(c0))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_ssm_decode_step_matches_jax(layer):
    jcfg, jl, cfg, tl = layer
    r = np.random.RandomState(22)
    x = (r.randn(3, 1, cfg.d_model) * 0.5).astype(np.float32)
    s0 = (r.randn(3, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
          * 0.3).astype(np.float32)
    c0 = (r.randn(3, cfg.ssm_conv_width - 1, tssm.conv_channels(cfg))
          * 0.3).astype(np.float32)
    want = jssm.ssm_decode_step(jnp.asarray(x), jl, jcfg, jnp.asarray(s0),
                                jnp.asarray(c0))
    state, conv = torch.from_numpy(s0), torch.from_numpy(c0)
    got = tssm.ssm_decode_step(torch.from_numpy(x), tl, cfg, state, conv)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    # the inputs are left as they were
    assert np.array_equal(state.numpy(), s0)
    assert np.array_equal(conv.numpy(), c0)


def test_decode_steps_continue_the_prefill(layer):
    """Prefill of L tokens then one recurrent step equals the last row of a
    prefill of L + 1 tokens (the state and conv window carry over)."""
    _, _, cfg, tl = layer
    r = np.random.RandomState(23)
    x = torch.from_numpy((r.randn(2, 41, cfg.d_model) * 0.5)
                         .astype(np.float32))
    full, s_full, c_full = tssm.ssm_forward(x, tl, cfg)
    _, s, c = tssm.ssm_forward(x[:, :40], tl, cfg)
    out, s, c = tssm.ssm_decode_step(x[:, 40:], tl, cfg, s, c)
    _close(out.numpy(), full[:, 40:].numpy())
    _close(s.numpy(), s_full.numpy())
    _close(c.numpy(), c_full.numpy())


def test_causal_conv_continues_prefill_bit_for_bit_in_bf16():
    """bf16: the conv over L + 1 tokens in one call and over L tokens then
    one more from the carried window (decode's call) give the same bits;
    each output is the fp32 sum of the bf16 products, rounded once."""
    r = np.random.RandomState(24)
    W, C, L = 4, 96, 33

    def bf16(*shape, scale=1.0):
        return torch.from_numpy((r.randn(*shape) * scale)
                                .astype(np.float32)).bfloat16()

    stream, w, b = bf16(2, L + 1, C), bf16(W, C, scale=0.2), bf16(C)
    init = bf16(2, W - 1, C)
    whole, win_whole = tssm.causal_conv(stream, w, b, init)
    head, win = tssm.causal_conv(stream[:, :L], w, b, init)
    last, win_last = tssm.causal_conv(stream[:, L:], w, b, win)
    assert whole.dtype == torch.bfloat16
    assert torch.equal(whole[:, :L], head)
    assert torch.equal(whole[:, L:], last)
    assert torch.equal(win_whole, win_last)
    padded = torch.cat([init, stream], dim=1).double()
    exact = sum(padded[:, i:i + L + 1] * w[i].double() for i in range(W))
    rounded_once = torch.nn.functional.silu(exact.float().bfloat16() + b)
    # the fp32 and float64 sums of four bf16 products round to the same
    # bf16 value unless the sum lies within an fp32 step of a bf16
    # rounding boundary; at this seed none does
    assert torch.equal(whole, rounded_once)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_init_ssm_matches_jax_deterministic_leaves(arch):
    """The port's own init: the JAX package's constant leaves, in fp32 for
    dt_bias/A_log/D even when the weights are bf16.  dt_bias is computed
    in float64 and rounded once, where JAX computes it in fp32, so it is
    held to a relative 1e-5 (a few fp32 ulps); the others are exact."""
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    own = tm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    js, ts = jp["blocks"]["ssm"], own["blocks"]["ssm"]
    for key in ("A_log", "D", "norm_w", "conv_b"):
        np.testing.assert_array_equal(ts[key].float().numpy(),
                                      np.asarray(js[key], np.float32))
    np.testing.assert_allclose(ts["dt_bias"].numpy(),
                               np.asarray(js["dt_bias"]), rtol=1e-5)
    for key, leaf in ts.items():
        want = torch.float32 if key in tssm.FP32_KEYS else torch.bfloat16
        assert leaf.dtype == want, key
        assert str(np.asarray(js[key]).dtype) == str(want).split(".")[1], key


def test_bf16_conversion_keeps_fp32_leaves():
    """A bf16 JAX tree of the hybrid converts with dt_bias/A_log/D in fp32
    and every other leaf in bf16, each value as JAX holds it."""
    jcfg = jax_smoke_config("hymba-1.5b")
    cfg = get_smoke_config("hymba-1.5b")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu",
                         dtype=torch.bfloat16)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [k.key for k in path]
        node = tp
        for k in keys:
            node = node[k]
        fp32 = keys[:2] == ["blocks", "ssm"] and keys[2] in tssm.FP32_KEYS
        assert node.dtype == (torch.float32 if fp32 else torch.bfloat16), \
            keys
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_convert_checks_the_ssm_tree():
    """An attention-free tree passes the key check (it has no
    blocks.attn); a tree whose SSM width does not match the config is
    refused."""
    jcfg = jax_smoke_config("mamba2-370m")
    cfg = get_smoke_config("mamba2-370m")
    tree = jax.tree.map(np.asarray,
                        jm.init_params(jcfg, jax.random.PRNGKey(0),
                                       jnp.float32))
    assert "attn" not in tree["blocks"]
    from_jax_params(tree, cfg, "cpu")
    tree["blocks"]["ssm"]["w_x"] = tree["blocks"]["ssm"]["w_x"][..., :-1]
    with pytest.raises(ValueError, match="blocks.ssm.w_x"):
        from_jax_params(tree, cfg, "cpu")
