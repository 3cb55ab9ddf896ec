"""The JAX package's train plan executed by the port's trainer on the CPU:
``make_train_step(cfg, tcfg, plan, mesh)`` on (data 2, model 2) with fsdp
and the sequence-parallel residual against JAX's unsharded
``make_train_step`` from the same state (``convert.train_state_from_jax``),
fp32, microbatches 2: the loss, ``grad_norm`` and ``lr`` within LOSS_RTOL,
every parameter leaf within PARAM_ATOL and the moments within
MOMENT_RTOL of each leaf's largest value after one and three steps
(``gather_train_state`` gives the logical state).  Also: olmoe's
load-balance loss and capacity groups at a batch whose ``_pick_groups``
differs on a data shard's rows (a capacity group spans both shards);
data shards holding unequal numbers of valid tokens; repeats bit-equal;
the mesh of ones bit-equal to the unsharded step; a checkpoint saved
under one plan restored under another or none, and a sharded run resumed
from it bit-equal to the uninterrupted one.
"""
import copy
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_plan_forward import cpu_mesh, one_thread  # noqa: F401
from test_torch_train import jax_state

import repro.train.trainer as jtr
from repro.train.optimizer import AdamWConfig as JAdamW
from repro_torch.convert import train_state_from_jax
from repro_torch.launch import sharding as shd
from repro_torch.models import moe
from repro_torch.train import trainer as ttr
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
MOMENT_RTOL = 1e-4
# a short warmup, so that three steps move the parameters
OPT = dict(warmup_steps=2, total_steps=50)


def batches(cfg, B: int, S: int, n: int, seed: int = 0,
            unequal: bool = False) -> list[dict]:
    """``n`` numpy batches; with ``unequal`` the second half of the rows
    (the second data shard's) has most of its labels ignored."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {"tokens": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
        b["labels"][0, :3] = -1
        if unequal:
            b["labels"][B // 2:, 5:] = -1
            b["labels"][B - 1, :] = -1
        out.append(b)
    return out


def run_both(arch: str, data: list, dp: int = 2, tp: int = 2,
             microbatches: int = 2, fsdp: bool = True):
    """JAX's unsharded steps and the port's sharded ones on ``data``:
    (JAX state, JAX metrics, port logical state, port metrics, plan)."""
    jcfg, cfg, np_state = jax_state(arch)
    jtcfg = jtr.TrainConfig(remat=True, microbatches=microbatches,
                            compute_dtype=jnp.float32, opt=JAdamW(**OPT))
    tcfg = ttr.TrainConfig(remat=True, microbatches=microbatches,
                           compute_dtype=torch.float32,
                           opt=AdamWConfig(**OPT))
    plan, run_cfg = shd.make_plan(cfg, "train", False,
                                  data[0]["labels"].shape[0], tp=tp,
                                  fsdp=fsdp)
    mesh = cpu_mesh(dp, tp)
    jstep = jax.jit(jtr.make_train_step(jcfg, jtcfg))
    step = ttr.make_train_step(run_cfg, tcfg, plan, mesh)
    jstate = jax.tree.map(jnp.asarray, np_state)
    state = shd.shard_train_state(train_state_from_jax(np_state, cfg, "cpu"),
                                  run_cfg, plan, mesh)
    jms, ms = [], []
    for batch in data:
        jstate, jm_ = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, ttr.batch_to_device(batch, "cpu"))
        jms.append(jm_)
        ms.append(m)
    return (jstate, jms, shd.gather_train_state(state, run_cfg, plan, mesh),
            ms, plan)


def check_against_jax(jstate, jms, state, ms):
    for jm_, m in zip(jms, ms):
        for k in ("nll", "accuracy", "aux_loss", "tokens", "grad_norm",
                  "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"])
    for (path, g), w in zip(shd.leaves_with_paths(state["params"]),
                            jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=PARAM_ATOL,
                                   rtol=0, err_msg=str(path))
    for key in ("m", "v"):
        for (path, g), w in zip(shd.leaves_with_paths(state["opt"][key]),
                                jax.tree.leaves(jstate["opt"][key])):
            w = np.asarray(w)
            err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= MOMENT_RTOL, (key, path, err)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m", "hymba-1.5b"])
def test_sharded_steps_match_jax(arch, steps):
    """(data 2, model 2), fsdp and the sequence-parallel residual,
    microbatches 2."""
    _, cfg, _ = jax_state(arch)
    out = run_both(arch, batches(cfg, 4, 32, steps))
    assert out[-1].fsdp and out[-1].rules["act_seq"] == "model"
    check_against_jax(*out[:4])


def test_unequal_valid_tokens_across_data_shards():
    """The second data shard's rows hold 5 valid labels each and its last
    row none: the loss is the whole batch's (nll and token counts summed
    over the shards, divided once), not a mean of the shards' losses."""
    _, cfg, _ = jax_state("yi-9b")
    data = batches(cfg, 4, 32, 2, seed=4, unequal=True)
    out = run_both("yi-9b", data, microbatches=1)
    check_against_jax(*out[:4])
    assert float(out[3][0]["tokens"]) == 2 * 32 - 3 + 5


def test_olmoe_capacity_groups_span_data_shards():
    """210 sequences of 32 tokens take the capacity path (> 2048 tokens):
    the whole batch's ``_pick_groups`` gives 105 groups of 2 rows, a data
    shard's 105 rows alone would give 35 groups of 3 (another capacity,
    other drops), and group 52 spans both shards.  The step (aux loss
    from the summed expert counts and probabilities) matches JAX's."""
    _, cfg, _ = jax_state("olmoe-1b-7b")
    B, S = 210, 32
    E, K = cfg.n_experts, cfg.top_k
    assert B * S > moe.DENSE_TOKENS
    assert moe._pick_groups(S, B, E, K) == 105
    assert moe._pick_groups(S, B // 2, E, K) == 35
    data = batches(cfg, B, S, 1, seed=5)
    out = run_both("olmoe-1b-7b", data, microbatches=1)
    assert out[-1].rules["act_seq"] is None
    assert float(out[3][0]["aux_loss"]) > 0
    check_against_jax(*out[:4])


def sharded_setup(arch: str = "yi-9b", dp: int = 2, tp: int = 2,
                  fsdp: bool = True):
    jcfg, cfg, np_state = jax_state(arch)
    tcfg = ttr.TrainConfig(remat=True, microbatches=2,
                           compute_dtype=torch.float32,
                           opt=AdamWConfig(**OPT))
    plan, run_cfg = shd.make_plan(cfg, "train", False, 4, tp=tp, fsdp=fsdp)
    mesh = cpu_mesh(dp, tp)
    logical = train_state_from_jax(np_state, cfg, "cpu")
    return (run_cfg, tcfg, plan, mesh, logical,
            ttr.make_train_step(run_cfg, tcfg, plan, mesh))


def leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(
        shd.leaves_with_paths(a), shd.leaves_with_paths(b)))


def test_repeats_are_bit_equal():
    cfg, _, plan, mesh, logical, step = sharded_setup()
    data = [ttr.batch_to_device(b, "cpu") for b in batches(cfg, 4, 32, 2)]
    runs = []
    for _ in range(2):
        state = shd.shard_train_state(copy.deepcopy(logical), cfg, plan,
                                      mesh)
        for b in data:
            state, m = step(state, b)
        runs.append((shd.gather_train_state(state, cfg, plan, mesh), m))
    assert leaves_equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])


def test_mesh_of_ones_step_is_bit_equal_to_unsharded():
    cfg, tcfg, plan, mesh, logical, step = sharded_setup(dp=1, tp=1)
    data = [ttr.batch_to_device(b, "cpu") for b in batches(cfg, 4, 32, 2)]
    state = shd.shard_train_state(copy.deepcopy(logical), cfg, plan, mesh)
    ref = copy.deepcopy(logical)
    ustep = ttr.make_train_step(cfg, tcfg)
    for b in data:
        state, m = step(state, b)
        ref, um = ustep(ref, b)
        assert all(torch.equal(m[k], um[k]) for k in m)
    assert leaves_equal(shd.gather_train_state(state, cfg, plan, mesh), ref)


def test_checkpoint_across_plans_and_resume(tmp_path):
    """Saved under (data 2, model 2) with fsdp: the files hold the logical
    arrays (restored unsharded equal to the gathered state), restored
    under (data 4, model 2) without fsdp they gather to the same state,
    and a run resumed under the saving plan equals the uninterrupted one
    bit for bit."""
    cfg, tcfg, plan, mesh, logical, step = sharded_setup()
    data = [ttr.batch_to_device(b, "cpu") for b in batches(cfg, 4, 32, 3)]
    state = shd.shard_train_state(copy.deepcopy(logical), cfg, plan, mesh)
    state, _ = step(state, data[0])
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(state, 1, blocking=True, layout=(cfg, plan, mesh))
    saved = shd.gather_train_state(state, cfg, plan, mesh)
    plain = ckpt.restore(copy.deepcopy(logical), 1)
    assert leaves_equal(plain, saved)
    plan4, _ = shd.make_plan(cfg, "train", False, 4, tp=2, fsdp=False)
    mesh4 = cpu_mesh(4, 2)
    other = ckpt.restore(shd.shard_train_state(copy.deepcopy(logical), cfg,
                                               plan4, mesh4), 1,
                         layout=(cfg, plan4, mesh4))
    assert leaves_equal(shd.gather_train_state(other, cfg, plan4, mesh4),
                        saved)
    resumed = ckpt.restore(shd.shard_train_state(copy.deepcopy(logical),
                                                 cfg, plan, mesh), 1,
                           layout=(cfg, plan, mesh))
    for b in itertools.islice(data, 1, None):
        state, m = step(state, b)
        resumed, mr = step(resumed, b)
        assert all(torch.equal(m[k], mr[k]) for k in m)
    assert leaves_equal(shd.gather_train_state(state, cfg, plan, mesh),
                        shd.gather_train_state(resumed, cfg, plan, mesh))


def test_trainer_with_a_plan_resumes(tmp_path):
    """``Trainer(plan=, mesh=)`` runs sharded, checkpoints the logical
    state and, rebuilt on the same directory, resumes from it."""
    from repro_torch.data.pipeline import DataConfig, packed_batches
    cfg, tcfg, plan, mesh, _, _ = sharded_setup()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4)
    tr = ttr.Trainer(cfg, tcfg, packed_batches(dc), str(tmp_path),
                     checkpoint_every=0, device="cpu", plan=plan, mesh=mesh)
    hist = tr.run(2, log_every=1)
    assert len(hist) == 2 and all(np.isfinite(h["nll"]) for h in hist)
    again = ttr.Trainer(cfg, tcfg, packed_batches(dc), str(tmp_path),
                        device="cpu", plan=plan, mesh=mesh)
    assert again.step == 2
    assert leaves_equal(shd.gather_train_state(again.state, cfg, plan, mesh),
                        shd.gather_train_state(tr.state, cfg, plan, mesh))
