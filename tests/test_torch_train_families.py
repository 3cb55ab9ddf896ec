"""The trainer's loss and gradients for the other model families against
the JAX package on the CPU, fp32 compute: olmoe-1b-7b (MoE, with the
load-balance loss in the total), opt-30b (sinusoidal positions, biases,
GELU), musicgen-medium (stub-frontend ``embeds``), mamba2-370m and
hymba-1.5b (the SSD mixer through its plain version, as on the CPU
everywhere).  Loss within 1e-5 relative, every gradient leaf
within 1e-4 of its largest |value|; and one AdamW step of each, parameters
within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (PARAM_ATOL, check_loss_and_grads, jax_state,
                              make_batch)

import repro.train.trainer as jtr
from repro_torch.convert import train_state_from_jax
from repro_torch.train import trainer as ttr
from repro_torch.train.optimizer import tree_leaves

ARCHS = ["olmoe-1b-7b", "opt-30b", "musicgen-medium", "mamba2-370m",
         "hymba-1.5b"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """S = 70 spans two SSD chunks of the smoke configs (64 positions)."""
    metrics = check_loss_and_grads(arch, S=70)
    if arch == "olmoe-1b-7b":
        assert float(metrics["aux_loss"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_jax(arch):
    """One ``make_train_step`` step (remat, fp32, AdamW's defaults) from
    one state: parameters within 1e-5, grad norm within 1e-5 relative."""
    jcfg, cfg, np_state = jax_state(arch)
    batch = make_batch(cfg, 2, 40, seed=1)
    jtcfg = jtr.TrainConfig(compute_dtype=jnp.float32)
    tcfg = ttr.TrainConfig(compute_dtype=torch.float32)
    jstate, jm = jax.jit(jtr.make_train_step(jcfg, jtcfg))(
        jax.tree.map(jnp.asarray, np_state), jax.tree.map(jnp.asarray, batch))
    state, m = ttr.make_train_step(cfg, tcfg)(
        train_state_from_jax(np_state, cfg, "cpu"),
        ttr.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    for g, w in zip(tree_leaves(state["params"]),
                    jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=PARAM_ATOL,
                                   rtol=0)
