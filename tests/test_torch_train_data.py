"""The trainer's parts without a model step, against the JAX package on the
CPU: the data pipeline (bit-equal batches), the cross-entropy, the AdamW
schedule, update, clipping and int8 compression (within 1e-6, relative
where the values are small), checkpoints (a JAX checkpoint restores into
the port's train state; the port's round trip, GC and uncommitted
directories) and the FLOP counts of the roofline.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train.optimizer as jopt
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import embeds_batches as j_embeds_batches
from repro.data.pipeline import packed_batches as j_packed_batches
from repro.models.config import flops_per_token_fwd as j_fwd_flops
from repro.models.config import flops_per_token_train as j_train_flops
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.losses import cross_entropy as j_cross_entropy
from repro.train.trainer import init_train_state as j_init_train_state
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import train_state_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.data.pipeline import embeds_batches, packed_batches
from repro_torch.models.config import (flops_per_token_fwd,
                                       flops_per_token_train)
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.losses import cross_entropy
from repro_torch.train.trainer import TrainConfig, init_train_state

RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 5])
def test_packed_and_embeds_batches_are_bit_equal_to_jax(seed):
    kw = dict(vocab_size=700, seq_len=48, batch_size=3, seed=seed)
    for mine, theirs in zip(_take(packed_batches(DataConfig(**kw)), 3),
                            _take(j_packed_batches(JDataConfig(**kw)), 3)):
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert mine[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(mine[k], theirs[k])
    for mine, theirs in zip(_take(embeds_batches(DataConfig(**kw), 24), 3),
                            _take(j_embeds_batches(JDataConfig(**kw), 24), 3)):
        assert mine.keys() == theirs.keys() == {"embeds", "labels"}
        for k in mine:
            assert mine[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(mine[k], theirs[k])


def test_pipeline_shapes_shift_and_learnable_structure():
    dc = DataConfig(vocab_size=1000, seq_len=64, batch_size=4, seed=3)
    a = next(packed_batches(dc))
    assert a["tokens"].shape == a["labels"].shape == (4, 64)
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    corpus = SyntheticCorpus(DataConfig(vocab_size=500, seq_len=128,
                                        batch_size=1))
    doc = corpus.doc(np.random.RandomState(0), 2000)
    pairs = {}
    for i in range(len(doc) - 2):
        pairs.setdefault((doc[i], doc[i + 1]), []).append(doc[i + 2])
    repeat = [len(set(v)) == 1 for v in pairs.values() if len(v) > 1]
    assert repeat and np.mean(repeat) > 0.5


def test_cross_entropy_matches_jax_with_padded_vocab_and_ignored_labels():
    cfg = dataclasses.replace(get_smoke_config("yi-9b"), vocab_size=250)
    jcfg = dataclasses.replace(jax_smoke_config("yi-9b"), vocab_size=250)
    V, Vpad = cfg.vocab_size, cfg.padded_vocab()
    assert Vpad > V
    r = np.random.RandomState(0)
    logits = (r.randn(3, 17, Vpad) * 3).astype(np.float32)
    logits[..., V:] = 50.0        # would dominate if the pad were counted
    labels = r.randint(0, V, (3, 17)).astype(np.int32)
    labels[0, :5] = -1
    labels[2, -3:] = -1
    labels[1, 4] = int(np.argmax(logits[1, 4, :V]))
    loss, m = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), cfg)
    jloss, jm = j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                jcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert float(m["tokens"]) == float(jm["tokens"]) == 51.0 - 8
    np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]),
                               atol=RTOL)
    assert float(m["accuracy"]) > 0


def test_lr_schedule_matches_jax_to_12000_steps():
    cfg = topt.AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=10_000)
    jcfg = jopt.AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=10_000)
    steps = np.concatenate([np.arange(0, 40), np.arange(40, 12_001, 97),
                            [9_999, 10_000, 10_001, 12_000]]).astype(np.int32)
    got = np.array([float(topt.lr_at(cfg, torch.tensor(int(s))))
                    for s in steps])
    want = np.asarray(jax.vmap(lambda s: jopt.lr_at(jcfg, s))(
        jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _tree(seed, scale=1.0):
    """A parameter-like tree: a matrix, a stacked 3-D leaf, 1-D gains."""
    r = np.random.RandomState(seed)
    return {"blocks": {"w": (r.randn(2, 9, 7) * scale).astype(np.float32),
                       "ln": (r.randn(2, 9) * scale).astype(np.float32)},
            "embed": (r.randn(33, 8) * scale).astype(np.float32),
            "final_norm": (r.randn(8) * scale).astype(np.float32)}


def _to_torch(tree):
    return topt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close_trees(got, want, rtol=RTOL):
    for g, w in zip(topt.tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rtol * max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_jax(clip):
    """Three updates from a mid-run state (step 7): decay on ndim >= 2
    only, the clip scale, fp32 bias corrections; params, moments, grad norm
    and lr within 1e-6 of each leaf's largest value."""
    cfg = topt.AdamWConfig(lr=1e-3, warmup_steps=5, grad_clip=clip)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=5, grad_clip=clip)
    params, m = _tree(0), _tree(1, 0.1)
    v = jax.tree.map(np.abs, _tree(2, 0.01))
    jstate = {"m": m, "v": v, "step": jnp.asarray(7, jnp.int32)}
    state = {"m": _to_torch(m), "v": _to_torch(v),
             "step": torch.tensor(7, dtype=torch.int32)}
    tparams, jparams = _to_torch(params), jax.tree.map(jnp.asarray, params)
    for i in range(3):
        grads = _tree(10 + i, 2.0)
        tparams, state, met = topt.adamw_update(tparams, _to_torch(grads),
                                                state, cfg)
        jparams, jstate, jmet = jopt.adamw_update(
            jparams, jax.tree.map(jnp.asarray, grads), jstate, jcfg)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=RTOL)
    _close_trees(tparams, jparams)
    _close_trees(state["m"], jstate["m"])
    _close_trees(state["v"], jstate["v"])
    assert int(state["step"]) == int(jstate["step"]) == 10


def test_clipping_and_global_norm_match_jax():
    grads = _tree(3, 5.0)
    clipped, norm = topt.clip_by_global_norm(_to_torch(grads), 1.0)
    jclipped, jnorm = jopt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=RTOL)
    assert float(norm) > 1.0
    _close_trees(clipped, jclipped)
    np.testing.assert_allclose(float(topt.global_norm(clipped)), 1.0,
                               rtol=1e-5)


def test_int8_compression_matches_jax():
    r = np.random.RandomState(4)
    tree = {"a": (r.randn(64, 33) * 0.3).astype(np.float32),
            "b": r.randn(5).astype(np.float32),
            "c": np.round(r.randn(300) * 2).astype(np.float32) / 254.0}
    for leaf in tree.values():
        q, s = topt.quantize_int8(torch.from_numpy(leaf))
        jq, js = jopt.quantize_int8(jnp.asarray(leaf))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL)
    out = topt.compress_roundtrip(_to_torch(tree))
    jout = jopt.compress_roundtrip(jax.tree.map(jnp.asarray, tree))
    _close_trees(out, jout)
    err = float((out["a"] - torch.from_numpy(tree["a"])).abs().max())
    assert 0 < err < 0.05


def test_flops_per_token_match_jax():
    from repro.configs import get_config as jax_config
    for name in ("yi-9b", "olmoe-1b-7b", "hymba-1.5b"):
        assert flops_per_token_train(get_config(name)) == j_train_flops(
            jax_config(name))
        assert flops_per_token_fwd(get_config(name)) == j_fwd_flops(
            jax_config(name))


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A train state that JAX's CheckpointManager wrote restores into the
    port's train state equal to ``train_state_from_jax`` of the same
    state, leaf paths and all."""
    jcfg, cfg = jax_smoke_config("olmoe-1b-7b"), get_smoke_config("olmoe-1b-7b")
    jstate = j_init_train_state(jcfg, jax.random.PRNGKey(0))
    r = np.random.RandomState(0)
    jstate["opt"]["m"] = jax.tree.map(
        lambda x: jnp.asarray(r.randn(*x.shape).astype(np.float32)),
        jstate["opt"]["m"])
    jstate["opt"]["step"] = jnp.asarray(9, jnp.int32)
    JCheckpointManager(str(tmp_path)).save(jstate, 9, blocking=True)
    template = init_train_state(cfg, 1, TrainConfig(), "cpu")
    restored, step = CheckpointManager(str(tmp_path)).restore_latest(template)
    want = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    assert step == 9
    got_l, want_l = topt.tree_leaves(restored), topt.tree_leaves(want)
    assert len(got_l) == len(want_l) == len(jax.tree.leaves(jstate))
    for g, w in zip(got_l, want_l):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(restored["opt"]["step"]) == 9


def test_bf16_train_state_roundtrips_bit_for_bit(tmp_path):
    """A bf16 train state (``param_dtype=torch.bfloat16``; the moments
    stay fp32) saves as the JAX package writes bf16 leaves, 2-byte raw
    records under the manifest dtype "bfloat16", and restores to the bit
    into a template of other values; the fp32 leaves' manifest entries
    keep their numpy names."""
    cfg = get_smoke_config("hymba-1.5b")
    state = init_train_state(cfg, 0, TrainConfig(param_dtype=torch.bfloat16),
                             "cpu")
    r = np.random.RandomState(2)
    for leaf in topt.tree_leaves(state["params"]):
        if leaf.dtype == torch.bfloat16:
            leaf.copy_(torch.from_numpy(r.randn(*leaf.shape).astype(
                np.float32)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 5)
    mgr.wait()
    other = init_train_state(cfg, 1, TrainConfig(param_dtype=torch.bfloat16),
                             "cpu")
    restored, step = mgr.restore_latest(other)
    assert step == 5
    got, want = topt.tree_leaves(restored), topt.tree_leaves(state)
    assert any(w.dtype == torch.bfloat16 for w in want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if w.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert torch.equal(g, w)
    d = tmp_path / "step_000000005"
    with open(d / "manifest.json") as f:
        entries = json.load(f)["leaves"]
    assert {e["dtype"] for e in entries} == {"bfloat16", "float32", "int32"}
    for e in entries:
        arr = np.load(d / e["file"])
        if e["dtype"] == "bfloat16":
            assert arr.dtype.kind == "V" and arr.dtype.itemsize == 2
        else:
            assert str(arr.dtype) == e["dtype"]


def test_jax_bf16_leaf_restores_into_the_port(tmp_path):
    """A bf16 leaf that JAX's CheckpointManager wrote (``|V2`` records,
    manifest dtype "bfloat16") restores into the port's bf16 leaf with
    the same bits, beside an fp32 and an int32 leaf."""
    r = np.random.RandomState(3)
    w = r.randn(5, 7).astype(np.float32)
    jstate = {"w": jnp.asarray(w).astype(jnp.bfloat16),
              "b": jnp.asarray(w[0]), "step": jnp.asarray(4, jnp.int32)}
    JCheckpointManager(str(tmp_path)).save(jstate, 4, blocking=True)
    template = {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                "b": torch.zeros(7),
                "step": torch.zeros((), dtype=torch.int32)}
    restored, step = CheckpointManager(str(tmp_path)).restore_latest(template)
    assert step == 4 and restored["w"].dtype == torch.bfloat16
    want = np.asarray(jstate["w"]).view(np.int16)
    assert np.array_equal(restored["w"].view(torch.int16).numpy(), want)
    assert torch.equal(restored["b"], torch.from_numpy(w[0]))
    assert int(restored["step"]) == 4


def test_checkpoint_roundtrip_gc_and_uncommitted(tmp_path):
    cfg = get_smoke_config("yi-9b")
    state = init_train_state(cfg, 0, TrainConfig(), "cpu")
    mgr = CheckpointManager(str(tmp_path / "a"), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(state, s, blocking=s % 2 == 0)
    mgr.wait()
    assert mgr.list_steps() == [3, 4]
    os.makedirs(tmp_path / "a" / "step_000000099")      # a crashed save
    os.makedirs(tmp_path / "a" / "step_000000098.tmp")
    assert mgr.list_steps() == [3, 4]
    other = init_train_state(cfg, 1, TrainConfig(), "cpu")
    restored, step = mgr.restore_latest(other)
    assert step == 4
    for g, w in zip(topt.tree_leaves(restored), topt.tree_leaves(state)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    with open(tmp_path / "a" / "step_000000004" / "manifest.json") as f:
        text = f.read()
    assert "['params']/['blocks']/['attn']/['wq']" in text


def test_async_save_holds_a_copy_taken_before_it_returns(tmp_path):
    """The port's optimizer updates in place: what ``save`` wrote is the
    state at the call, whatever happens to the tensors after it."""
    cfg = get_smoke_config("yi-9b")
    state = init_train_state(cfg, 0, TrainConfig(), "cpu")
    want = state["params"]["embed"].clone()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 1)
    state["params"]["embed"].add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore_latest(state)
    assert torch.equal(restored["params"]["embed"], want)
