"""The port's sharding plans, specs, meshes and head padding against the
JAX package's ``launch/sharding.py``, ``launch/mesh.py`` and
``launch/shapes.py``: pure functions of the config, so equal entry by
entry for every arch, mode, tp, pp and pod layout JAX accepts; the port's
``pad_attention_params`` equal to JAX's on the same numpy weights, and a
padded forward equal to the unpadded one within 1e-5 relative (as
``tests/test_sharding.py``'s ``head_padding_rel``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.shapes as jshapes
import repro.launch.sharding as jshd
import repro.models as jm
import repro_torch.configs as tconfigs
import repro_torch.launch.shapes as tshapes
import repro_torch.launch.sharding as tshd
from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import (make_production_mesh,
                                     make_replica_mesh, make_small_mesh)
from repro_torch.models import forward

torch.set_num_threads(1)

MODES = ("serve", "train", "prefill", "decode")
TPS = (1, 2, 4, 8, 16)
PPS = (1, 2)


def _entry(e):
    # a one-axis tuple and the bare axis name split alike (newer JAX
    # versions store ("data",) as "data")
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _specs(tree):
    """A spec tree as nested dicts of plain tuples (``None`` kept)."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if tree is None:
        return None
    return tuple(_entry(e) for e in tree)


def _cache(c):
    return {f: _specs(getattr(c, f)) for f in ("k", "v", "ssm", "conv", "pos")}


def _plan_view(mod, cfg, mode, tp, pp, multi_pod):
    batch = 1 if mode == "serve" else 8
    try:
        plan, run_cfg = mod.make_plan(cfg, mode, multi_pod, batch, tp=tp,
                                      pp=pp)
    except Exception as e:   # noqa: BLE001 — the port must fail alike
        return ("raises", type(e).__name__)
    params = mod.param_pspecs(run_cfg, plan)
    return dict(
        rules=plan.rules, fsdp=plan.fsdp, attn_mode=plan.attn_mode,
        tp=plan.tp, describe=plan.describe(),
        heads=(run_cfg.n_q_heads, run_cfg.n_kv_heads),
        resolve=mod.resolve_attn_mode(cfg, tp),
        pad=mod.pad_heads(cfg, tp),
        params=_specs(params), opt=_specs(mod.opt_pspecs(params)),
        pool=_specs(mod.pool_pspecs(run_cfg, plan)),
        cache=_cache(mod.cache_pspecs(run_cfg, plan)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", jconfigs.ALL_ARCHS)
def test_plans_and_specs_equal_jax(arch, mode):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    accepted = 0
    for tp in TPS:
        for pp in PPS:
            for multi_pod in (False, True):
                want = _plan_view(jshd, jcfg, mode, tp, pp, multi_pod)
                got = _plan_view(tshd, tcfg, mode, tp, pp, multi_pod)
                assert got == want, (arch, mode, tp, pp, multi_pod)
                accepted += isinstance(want, dict)
    assert accepted == len(TPS) * len(PPS) * 2


@pytest.mark.parametrize("case", [
    # tests/test_sharded_engine.py's three pad_heads cases
    dict(q=4, kv=4, tps=(4, 16, 32)),
    dict(q=6, kv=2, tps=(4,)),
    dict(q=8, kv=2, tps=(25,)),
    dict(q=2, kv=2, tps=(4, 16), attn_sharding="pad"),
])
def test_pad_heads_and_attn_mode_equal_jax(case):
    over = dict(n_q_heads=case["q"], n_kv_heads=case["kv"])
    if "attn_sharding" in case:
        over["attn_sharding"] = case["attn_sharding"]
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("yi-9b"), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("yi-9b"), **over)
    for tp in case["tps"]:
        assert tshd.pad_heads(tcfg, tp) == jshd.pad_heads(jcfg, tp)
        assert (tshd.resolve_attn_mode(tcfg, tp)
                == jshd.resolve_attn_mode(jcfg, tp))
        assert (dataclasses.asdict(tshd.padded_config(tcfg, tp))
                == dataclasses.asdict(jshd.padded_config(jcfg, tp)))
        jplan, jrun = jshd.make_plan(jcfg, "serve", False, 1, tp=tp)
        tplan, trun = tshd.make_plan(tcfg, "serve", False, 1, tp=tp)
        assert (tplan.rules, tplan.attn_mode) == (jplan.rules,
                                                  jplan.attn_mode)
        assert (trun is tcfg) == (jrun is jcfg)


def test_shape_cells_equal_jax():
    jc = {a: jconfigs.get_config(a) for a in jconfigs.ALL_ARCHS}
    tc = {a: tconfigs.get_config(a) for a in tconfigs.ALL_ARCHS}
    assert tshapes.cells(tc) == jshapes.cells(jc)
    assert ({k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()})
    for a in jconfigs.ALL_ARCHS:
        for s in jshapes.SHAPES:
            assert (tshapes.applicable(tc[a], tshapes.SHAPES[s])
                    == jshapes.applicable(jc[a], jshapes.SHAPES[s]))


def test_meshes_have_jax_shapes_and_errors():
    devs = ["cpu"] * 8
    m = make_replica_mesh(devs[:4], 2, 2)
    assert m.shape == {"pipe": 2, "model": 2} and m.axis_names == (
        "pipe", "model")
    assert (m.pp, m.tp, m.size) == (2, 2, 4)
    assert m.device(1, 0) == torch.device("cpu")
    # the JAX package's error, word for word
    with pytest.raises(ValueError,
                       match=r"replica mesh needs tp\*pp=4 devices, got 3"):
        make_replica_mesh(devs[:3], 2, 2)
    # chips tell apart meshes over the same (virtual) devices
    assert make_replica_mesh(devs[:2], 2, 1, chips=(0, 1)) != \
        make_replica_mesh(devs[:2], 2, 1, chips=(2, 3))
    assert make_replica_mesh(devs[:2], 2, 1, chips=(0, 1)) == \
        make_replica_mesh(devs[:2], 2, 1, chips=(0, 1))
    assert make_small_mesh(devs, model=2).shape == {"data": 4, "model": 2}
    assert make_production_mesh(["cpu"] * 256).shape == {
        "data": 16, "model": 16}
    assert make_production_mesh(["cpu"] * 512, multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}


def _padding_case(arch, q, kv, tp):
    over = dict(n_q_heads=q, n_kv_heads=kv, head_dim=16, d_model=96)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **over)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    # perturb the zero-initialised biases so the padding of every leaf
    # shows
    leaves, tree = jax.tree.flatten(jp)
    rng = np.random.RandomState(3)
    leaves = [jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(
        x.shape).astype(np.float32)) for x in leaves]
    jp = jax.tree.unflatten(tree, leaves)
    return jcfg, tcfg, jp


@pytest.mark.parametrize("arch,q,kv,tp", [
    ("yi-9b", 6, 2, 4),            # GQA: heads per group padded
    ("yi-9b", 3, 3, 4),            # MHA: q and kv padded together
    ("starcoder2-3b", 6, 2, 4),    # q/k/v biases
])
def test_pad_attention_params_equal_jax_and_preserve_forward(arch, q, kv,
                                                             tp):
    jcfg, tcfg, jp = _padding_case(arch, q, kv, tp)
    jpad_cfg = jshd.padded_config(jcfg, tp)
    tpad_cfg = tshd.padded_config(tcfg, tp)
    assert tpad_cfg.n_q_heads > tcfg.n_q_heads
    want = jax.tree.map(np.asarray,
                        jshd.pad_attention_params(jp, jcfg, jpad_cfg))
    tparams = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    got = tshd.pad_attention_params(tparams, tcfg, tpad_cfg)
    for name, w in want["blocks"]["attn"].items():
        np.testing.assert_array_equal(got["blocks"]["attn"][name].numpy(),
                                      w, err_msg=name)
    assert got["blocks"]["attn"]["wq"].shape[-1] == tpad_cfg.q_dim
    # the padded model computes the unpadded one's function
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, tcfg.vocab_size, (2, 16)).astype(np.int64))
    a = forward(tparams, tcfg, tokens)
    b = forward(got, tpad_cfg, tokens)
    rel = float((a - b).abs().max() / (a.abs().max() + 1e-9))
    assert rel < 1e-5, rel


def test_shard_params_views_and_split():
    """Co-located shards are views of the one weight copy; d_ff and vocab
    split by ``tensor_split``'s ranges, heads by ``attn_layout``, MoE
    experts or their ff and SSM heads by their specs."""
    cfg = tconfigs.get_smoke_config("yi-9b")
    from repro_torch.models import init_params
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    plan, run_cfg = tshd.make_plan(cfg, "serve", False, 1, tp=4, pp=2)
    mesh = make_replica_mesh(["cpu"] * 8, 4, 2)
    grid = tshd.shard_params(params, run_cfg, plan, mesh)
    wq = params["blocks"]["attn"]["wq"]
    for pi in range(2):
        for mi in range(4):
            s = grid[pi][mi]["blocks"]["attn"]["wq"]
            assert s.untyped_storage().data_ptr() == \
                wq.untyped_storage().data_ptr()
            assert s.shape == (1, cfg.d_model, cfg.head_dim)
            # 4 query heads over 2 KV heads at tp 4: KV replicates, each
            # shard keeps the one KV head its query head reads
            assert grid[pi][mi]["blocks"]["attn"]["wk"].shape[-1] == \
                cfg.head_dim
    assert tshd.attn_layout(run_cfg, plan.rules, 4) == [
        (0, 1, 0, 1), (1, 2, 0, 1), (2, 3, 1, 2), (3, 4, 1, 2)]
    assert tshd.split_ranges(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert [tuple(t.shape) for t in torch.tensor_split(
        torch.zeros(10), 4)] == [(3,), (3,), (2,), (2,)]
    assert tshd.layer_layout(3, {"layers": None}, 2) == [(0, 3), (3, 3)]
    # MoE and SSM leaves: experts ("ep") or every expert's ff ("tp") and
    # whole SSM heads over `model`, router and B/C whole, all views of the
    # one copy but conv_b (the shard's xs columns and the whole B/C tail)
    for arch in ("olmoe-1b-7b", "granite-moe-3b-a800m", "mamba2-370m",
                 "hymba-1.5b"):
        c = tconfigs.get_smoke_config(arch)
        p = init_params(c, seed=0, dtype=torch.float32, device="cpu")
        plan, run_cfg = tshd.make_plan(c, "serve", False, 1, tp=2)
        grid = tshd.shard_params(p, run_cfg, plan,
                                 make_replica_mesh(["cpu"] * 2, 2))
        for mi in range(2):
            b = grid[0][mi]["blocks"]
            for kind in ("moe", "ssm"):
                for name, leaf in b.get(kind, {}).items():
                    whole = p["blocks"][kind][name]
                    assert (leaf.untyped_storage().data_ptr()
                            == whole.untyped_storage().data_ptr()) == \
                        (name != "conv_b"), (arch, name)
            if c.is_moe:
                E, ff = c.n_experts, c.d_ff
                want = ((E // 2, ff) if plan.rules["experts"] == "model"
                        else (E, ff // 2))
                assert b["moe"]["w_gate"].shape[1:4:2] == want
                assert b["moe"]["w_down"].shape[1:3] == want
                assert b["moe"]["router"].shape == p["blocks"]["moe"][
                    "router"].shape
            if c.has_ssm:
                P, H = c.ssm_head_dim, c.ssm_heads // 2
                s = b["ssm"]
                assert s["w_x"].shape[-1] == s["norm_w"].shape[-1] == H * P
                assert s["dt_bias"].shape[-1] == H
                assert s["out_proj"].shape[1] == H * P
                assert s["w_B"].shape == p["blocks"]["ssm"]["w_B"].shape
                want = torch.cat([p["blocks"]["ssm"]["conv_b"][
                    :, mi * H * P:(mi + 1) * H * P],
                    p["blocks"]["ssm"]["conv_b"][:, c.d_inner:]], dim=1)
                assert torch.equal(s["conv_b"], want)
