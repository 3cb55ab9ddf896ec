"""The port's ``models/moe.py`` against the JAX package's, on the CPU.

JAX's ``init_moe`` weights (fp32) go to both packages as numpy arrays, and
so do the inputs, drawn from a seed.  ``moe_dense``, ``moe_block`` on its
dense and capacity paths, ``load_balance_loss`` and ``moe_ref`` agree
within ATOL = 1e-5 (the same fp32 sums in another order over d_model or
d_ff).  On the capacity path the kept/dropped pattern must be JAX's to the
row: the rows where ``moe_block`` differs from the drop-free oracle are
the same rows in both packages, and there are some at factors 1.0 and
0.5.  ``_pick_groups`` is an exact copy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as tmoe

ATOL = 1e-5
ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(arch):
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, jp, cfg, tp


def _x(seed, B, S, d):
    return np.random.RandomState(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _both(fn_j, fn_t, jp, jcfg, tp, cfg, x, *args):
    want = np.asarray(fn_j(jnp.asarray(x), jp, jcfg, *args))
    got = fn_t(torch.from_numpy(x), tp, cfg, *args).numpy()
    return got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_jax(arch):
    jcfg, jp, cfg, tp = _weights(arch)
    got, want = _both(jmoe.moe_dense, tmoe.moe_dense, jp, jcfg, tp, cfg,
                      _x(0, 3, 17, cfg.d_model))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_dense_path_matches_jax(arch):
    """2048 tokens, the most the dense path takes."""
    jcfg, jp, cfg, tp = _weights(arch)
    got, want = _both(jmoe.moe_block, tmoe.moe_block, jp, jcfg, tp, cfg,
                      _x(1, 2, 1024, cfg.d_model))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,S", [(3, 1024), (1, 2304)],
                         ids=["three-groups", "one-group"])
@pytest.mark.parametrize("cf", [2.0, 1.0, 0.5])
def test_moe_block_capacity_path_drops_as_jax(B, S, cf):
    """The capacity path (B * S > 2048) at three capacity factors: outputs
    within ATOL, and the rows that a drop changes from the oracle are
    JAX's rows exactly; at 2.0 nothing drops, at 1.0 and 0.5 rows do."""
    jcfg, jp, cfg, tp = _weights("olmoe-1b-7b")
    x = _x(2, B, S, cfg.d_model)
    assert tmoe._pick_groups(S, B, cfg.n_experts, cfg.top_k) == B
    got, want = _both(jmoe.moe_block, tmoe.moe_block, jp, jcfg, tp, cfg, x,
                      cf)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    oracle = np.asarray(jmoe.moe_ref(jnp.asarray(x), jp, jcfg))
    rows_j = np.abs(want - oracle).max(-1) > ATOL
    rows_t = np.abs(got - oracle).max(-1) > ATOL
    np.testing.assert_array_equal(rows_t, rows_j)
    _, _, _, keep, _ = tmoe.dispatch(torch.from_numpy(x), tp, cfg, cf)
    dropped = int((~keep).sum())
    if cf == 2.0:
        assert dropped == 0 and not rows_t.any()
    else:
        assert dropped > 0 and rows_t.sum() > 0
    # a row differs from the oracle exactly when one of its slots dropped
    np.testing.assert_array_equal(
        (~keep).reshape(B * S, -1).any(-1).numpy(), rows_t.reshape(-1))


def test_moe_block_capacity_factor_default_is_the_config_one():
    jcfg, jp, cfg, tp = _weights("olmoe-1b-7b")
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.75)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=0.75)
    x = _x(3, 3, 1024, cfg.d_model)
    got, want = _both(jmoe.moe_block, tmoe.moe_block, jp, jcfg, tp, cfg, x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert torch.equal(torch.from_numpy(got), tmoe.moe_block(
        torch.from_numpy(x), tp, cfg, 0.75))


@pytest.mark.parametrize("arch", ARCHS)
def test_load_balance_loss_and_moe_ref_match_jax(arch):
    jcfg, jp, cfg, tp = _weights(arch)
    x = _x(4, 2, 40, cfg.d_model)
    got, want = _both(jmoe.load_balance_loss, tmoe.load_balance_loss, jp,
                      jcfg, tp, cfg, x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    got, want = _both(jmoe.moe_ref, tmoe.moe_ref, jp, jcfg, tp, cfg, x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_pick_groups_is_jax_s():
    for S in (1, 7, 16, 64, 1000, 1024):
        for B in range(1, 13):
            for E in (8, 40, 64):
                for K in (0, 1, 2, 8):
                    assert (tmoe._pick_groups(S, B, E, K)
                            == jmoe._pick_groups(S, B, E, K)), (S, B, E, K)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_has_jax_layout(arch):
    """Keys, shapes and dtypes as JAX's init (router fp32 under bf16), and
    the draws' standard deviations at JAX's scales."""
    jcfg, jp, cfg, _ = _weights(arch)
    gen = torch.Generator().manual_seed(0)

    def normal(shape, std, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype).normal_(0.0, std,
                                                       generator=gen)

    own = tmoe.init_moe(dataclasses.replace(cfg, n_layers=1), normal)
    assert set(own) == set(jp)
    for k, v in jp.items():
        assert tuple(own[k].shape) == (1,) + v.shape, k
        assert own[k].dtype == (torch.float32 if k == "router"
                                else torch.bfloat16), k
        np.testing.assert_allclose(float(own[k].float().std()),
                                   float(np.std(v)), rtol=0.1)
