"""The JAX package's train plan executed by the port on the CPU: the
forward of ``models.sharded.PlanModel`` (data groups, fsdp rows gathered
a layer at a time, the sequence-parallel residual) against JAX's
unsharded ``forward`` on the same weights (``convert.from_jax_params``),
fp32, within REL = 1e-4 of the logits' largest value (the reference the
JAX package's own sharding test holds its sharded program to, at 2e-2);
the mesh of ones bit-equal to the port's unsharded forward; granite-moe's
padded heads at tp 4 (the JAX test's head-padding case); and the plan
meshes' coordinates and the logical cut and gather of parameters.

Meshes are of CPU "virtual chips": (data 4, model 2) as the JAX test's,
(data 2, model 2) and the mesh of ones.  Helpers here are shared with
``test_torch_plan_serve.py`` and ``test_torch_plan_train.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import perturbed

import repro.models as jm
from repro.configs import get_smoke_config as jax_smoke_config
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import Mesh, make_small_mesh
from repro_torch.models import model as tmodel
from repro_torch.models import sharded

REL = 1e-4
ARCHS = ["yi-9b", "olmoe-1b-7b", "mamba2-370m", "hymba-1.5b"]
MESHES = [(4, 2), (2, 2)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(dp: int, tp: int) -> Mesh:
    """A (data dp, model tp) mesh of CPU virtual chips."""
    return make_small_mesh(["cpu"] * (dp * tp), model=tp)


@functools.lru_cache(maxsize=None)
def weights(arch: str, **over):
    """(JAX cfg, JAX params, port cfg, port fp32 params) of ``arch``'s
    smoke config (fields ``over`` replaced in both), every all-zero leaf
    perturbed so that biases and norm gains count."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), **over)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_tree = perturbed(jax.tree.map(np.asarray, jp), seed=7)
    return (jcfg, jax.tree.map(jnp.asarray, np_tree), cfg,
            from_jax_params(np_tree, cfg, "cpu", torch.float32))


def tokens_for(cfg, B: int, S: int, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(
        want, dtype=np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def plan_model(params, cfg, kind: str, B: int, dp: int, tp: int, **kw):
    """(PlanModel, plan, mesh) of ``kind``'s plan for a global batch of B
    on a (dp, tp) CPU mesh; the params padded in "pad" mode."""
    plan, run_cfg = shd.make_plan(cfg, kind, False, B, tp=tp, **kw)
    if run_cfg is not cfg:
        params = shd.pad_attention_params(params, cfg, run_cfg)
    mesh = cpu_mesh(dp, tp)
    return sharded.PlanModel.build(params, run_cfg, plan, mesh), plan, mesh


def plan_logits(params, cfg, tokens: np.ndarray, dp: int, tp: int,
                **kw) -> tuple[torch.Tensor, object]:
    """The train plan's logits of ``tokens`` (joined over the data
    groups) and the plan."""
    pm, plan, mesh = plan_model(params, cfg, "train", tokens.shape[0], dp,
                                tp, **kw)
    parts = shd.shard_batch({"tokens": torch.from_numpy(tokens)}, plan,
                            mesh)
    return torch.cat(sharded.forward_plan(
        pm, [p["tokens"] for p in parts])), plan


@functools.lru_cache(maxsize=None)
def jax_logits(arch: str, B: int, S: int) -> np.ndarray:
    jcfg, jparams, cfg, _ = weights(arch)
    return np.asarray(jax.jit(lambda p, t: jm.forward(p, jcfg, t))(
        jparams, jnp.asarray(tokens_for(cfg, B, S))))


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no-fsdp"])
@pytest.mark.parametrize("dp,tp", MESHES, ids=[f"d{d}m{t}" for d, t in
                                               MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_plan_forward_matches_jax(arch, dp, tp, fsdp):
    """Batch over data, fsdp rows (or none), heads/d_ff/vocab/experts/SSM
    heads over model and, except olmoe (``seq_parallel=False``), the
    residual split along the sequence over model."""
    B, S = 8, 32
    _, _, cfg, params = weights(arch)
    got, plan = plan_logits(params, cfg, tokens_for(cfg, B, S), dp, tp,
                            fsdp=fsdp)
    assert plan.fsdp == fsdp and plan.rules["batch"] == ("data",)
    assert plan.rules["act_seq"] == (None if arch == "olmoe-1b-7b"
                                     else "model")
    assert got.shape == (B, S, cfg.padded_vocab())
    assert rel_err(got.numpy(), jax_logits(arch, B, S)) <= REL


@pytest.mark.parametrize("arch", ARCHS + ["gemma2-2b"])
def test_mesh_of_ones_is_bit_equal_to_unsharded(arch):
    """Every axis of size 1: the plan executor does exactly the unsharded
    model's operations."""
    _, _, cfg, params = weights(arch)
    tokens = tokens_for(cfg, 4, 24)
    got, _ = plan_logits(params, cfg, tokens, 1, 1)
    assert torch.equal(got, tmodel.forward(params, cfg,
                                           torch.from_numpy(tokens)))


def test_granite_padded_heads_at_tp4_match_jax():
    """The JAX test's head-padding case: 6 query heads over 2 KV heads do
    not divide tp 4, so the plan pads them ("pad": 8 heads, zero weights
    at the padded ones) and the padded sharded model computes the
    unpadded function."""
    over = dict(n_q_heads=6, n_kv_heads=2, head_dim=16, d_model=96)
    jcfg, jparams, cfg, params = weights("granite-moe-3b-a800m", **over)
    tokens = tokens_for(cfg, 4, 16, seed=2)
    got, plan = plan_logits(params, cfg, tokens, 2, 4)
    assert plan.attn_mode == "pad"
    want = jm.forward(jparams, jcfg, jnp.asarray(tokens))
    assert rel_err(got.numpy(), want) <= REL


def test_plan_mesh_coordinates():
    """Flat batch index over ("pod", "data"), pod major; devices, chips
    and axis sizes at a coordinate."""
    devs = [f"cpu:{i}" for i in range(8)]
    mesh = Mesh(np.asarray(devs, dtype=object).reshape(2, 2, 2),
                ("pod", "data", "model"), chips=list(range(8)))
    assert mesh.batch_axes == ("pod", "data") and mesh.n_batch == 4
    assert mesh.tp == 2 and mesh.axis_size(("data", "model")) == 4
    assert mesh.axis_size(None) == 1
    assert [mesh.batch_coord(b) for b in range(4)] == [
        {"pod": 0, "data": 0}, {"pod": 0, "data": 1},
        {"pod": 1, "data": 0}, {"pod": 1, "data": 1}]
    assert mesh.at(3, 1) == mesh.device(1, 1, 1) == torch.device("cpu:7")
    assert mesh.group(2) == [torch.device("cpu:4"), torch.device("cpu:5")]
    assert mesh.chip(1, 0, 1) == 5
    small = cpu_mesh(4, 2)
    assert small.batch_axes == ("data",) and small.n_batch == 4


@pytest.mark.parametrize("arch,dp,tp,pods", [
    ("yi-9b", 4, 2, 1), ("hymba-1.5b", 2, 2, 1), ("olmoe-1b-7b", 2, 2, 2),
    ("mamba2-370m", 2, 2, 1)])
def test_fsdp_cut_and_gather_are_inverse(arch, dp, tp, pods):
    """``shard_params`` with fsdp cuts each leaf's fsdp row axis over the
    data index (replicated over pods) and its model axis as the serve
    plan does; ``gather_logical`` gives back every leaf bit for bit, and
    a coordinate's fsdp rows are its slice of ``split_ranges``."""
    _, _, cfg, params = weights(arch)
    plan, run_cfg = shd.make_plan(cfg, "train", pods > 1, 8, tp=tp)
    axes = ("pod", "data", "model") if pods > 1 else ("data", "model")
    shape = (pods, dp, tp) if pods > 1 else (dp, tp)
    mesh = Mesh(np.asarray(["cpu"] * (pods * dp * tp),
                           dtype=object).reshape(shape), axes)
    grid = shd.shard_params(params, run_cfg, plan, mesh, copy=True)
    assert len(grid) == pods * dp and len(grid[0]) == tp
    back = shd.gather_logical(grid, run_cfg, plan, mesh)
    for (path, t), (_, u) in zip(shd.leaves_with_paths(params),
                                 shd.leaves_with_paths(back)):
        assert torch.equal(t, u), path
    if cfg.has_attn:
        wq = params["blocks"]["attn"]["wq"]
        rows = shd.split_ranges(wq.shape[1], dp)
        for b in range(pods * dp):
            r0, r1 = rows[b % dp]
            part = grid[b][0]["blocks"]["attn"]["wq"]
            assert part.shape[1] == r1 - r0
            assert torch.equal(part, wq[:, r0:r1, :part.shape[2]])
