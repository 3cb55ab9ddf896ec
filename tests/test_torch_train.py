"""The port's trainer against the JAX package's on the CPU: ``loss_fn``'s
value and every gradient leaf (fp32 compute: loss within 1e-5 relative,
each leaf within 1e-4 of its largest |value|), three ``make_train_step``
steps with microbatches and int8 gradient compression (parameters within
1e-5, the moments within 1e-4 of each leaf's largest value), remat equal
to no remat, bf16 compute (loss within 2e-2 relative), the loss falling
as in ``test_training_reduces_loss``, the ``Trainer``'s restart, and the
``train_100m`` twin.  The other model families are in
``test_torch_train_families.py``.
"""
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import perturbed

import repro.models as jm
import repro.train.trainer as jtr
from repro.configs import get_smoke_config as jax_smoke_config
from repro_torch.configs import get_smoke_config
from repro_torch.convert import train_state_from_jax
from repro_torch.data.pipeline import DataConfig, packed_batches
from repro_torch.models import forward
from repro_torch.train import trainer as ttr
from repro_torch.train.optimizer import AdamWConfig, tree_leaves, tree_map
from repro_torch.train_100m import main as train_100m

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5
BF16_LOSS_RTOL = 2e-2
# leaves whose gradient is zero in exact arithmetic, so that both packages
# return rounding noise there (~1e-10) and no leaf-relative limit holds:
# opt's key bias adds one constant to every score of a query row (no rope
# or qk-norm after it), which the softmax cancels.  Both must be below
# ZERO_GRAD_ATOL of the largest gradient value of all leaves
EXACT_ZERO_GRADS = {("opt-30b", "['blocks']['attn']['bk']")}
ZERO_GRAD_ATOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def jax_state(arch: str):
    """(JAX cfg, port cfg, numpy JAX train state): ``arch``'s smoke
    config, fp32, JAX's init with every all-zero parameter leaf perturbed
    (biases, norm gains), moments zero."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    state = jtr.init_train_state(jcfg, jax.random.PRNGKey(0))
    np_state = jax.tree.map(np.asarray, state)
    np_state["params"] = perturbed(np_state["params"], seed=11)
    return jcfg, cfg, np_state


def make_batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    """numpy labels and tokens (or stub-frontend embeds), some labels -1."""
    r = np.random.RandomState(seed)
    batch = {"labels": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    if cfg.modality == "audio_stub":
        batch["embeds"] = (r.randn(B, S, cfg.d_model) * 0.02).astype(
            np.float32)
    else:
        batch["tokens"] = r.randint(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    return batch


def check_loss_and_grads(arch: str, B: int = 2, S: int = 40,
                         compute=(torch.float32, jnp.float32),
                         loss_rtol=LOSS_RTOL, grad_rtol=GRAD_RTOL):
    """``loss_fn``'s total loss, metrics and gradients from one state and
    batch in both packages."""
    jcfg, cfg, np_state = jax_state(arch)
    batch = make_batch(cfg, B, S)
    jtcfg = jtr.TrainConfig(remat=False, compute_dtype=compute[1])
    tcfg = ttr.TrainConfig(remat=False, compute_dtype=compute[0])
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.loss_fn(p, jcfg, b, jtcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, np_state["params"]),
        jax.tree.map(jnp.asarray, batch))
    params = train_state_from_jax(np_state, cfg, "cpu")["params"]
    total, metrics, grads = ttr.value_and_grad(
        params, cfg, ttr.batch_to_device(batch, "cpu"), tcfg)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=loss_rtol)
    for k in ("nll", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=loss_rtol, atol=1e-7)
    if grad_rtol is None:
        return metrics
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(jleaves)
    top = max(float(np.abs(np.asarray(w)).max()) for _, w in jleaves)
    for g, (path, w) in zip(leaves, jleaves):
        w, key = np.asarray(w), jax.tree_util.keystr(path)
        assert g.shape == w.shape, key
        if (arch, key) in EXACT_ZERO_GRADS:
            assert max(np.abs(w).max(), float(g.abs().max())) <= \
                ZERO_GRAD_ATOL * top, key
            continue
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= grad_rtol, (key, err)
    return metrics


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-2b"])
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch, S=40 if arch == "yi-9b" else 90)


def test_bf16_compute_loss_matches_jax():
    check_loss_and_grads("yi-9b", compute=(torch.bfloat16, jnp.bfloat16),
                         loss_rtol=BF16_LOSS_RTOL, grad_rtol=None)


@pytest.mark.parametrize("compression", [False, True])
def test_three_steps_with_microbatches_match_jax(compression):
    """make_train_step at microbatches=2, with and without grad_compression,
    fp32, from one state: params within 1e-5 after 3 steps (AdamW's
    defaults), metrics alike.  Without compression the moments agree within
    1e-4 of each leaf's largest value; with it a gradient element within
    rounding of a quantization boundary may land one int8 step apart in the
    two packages (a 1/127 of its block's largest value), so there the
    moments are not compared."""
    jcfg, cfg, np_state = jax_state("yi-9b")
    jtcfg = jtr.TrainConfig(remat=True, microbatches=2,
                            grad_compression=compression,
                            compute_dtype=jnp.float32)
    tcfg = ttr.TrainConfig(remat=True, microbatches=2,
                           grad_compression=compression,
                           compute_dtype=torch.float32)
    jstep = jax.jit(jtr.make_train_step(jcfg, jtcfg))
    step = ttr.make_train_step(cfg, tcfg)
    jstate = jax.tree.map(jnp.asarray, np_state)
    state = train_state_from_jax(np_state, cfg, "cpu")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4)
    for batch in itertools.islice(packed_batches(dc), 3):
        jstate, jm_ = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, ttr.batch_to_device(batch, "cpu"))
        for k in ("nll", "accuracy", "aux_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]),
                                       rtol=LOSS_RTOL, atol=1e-7)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 3
    for g, w in zip(tree_leaves(state["params"]),
                    jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=PARAM_ATOL,
                                   rtol=0)
    for key in () if compression else ("m", "v"):
        for g, w in zip(tree_leaves(state["opt"][key]),
                        jax.tree.leaves(jstate["opt"][key])):
            w = np.asarray(w)
            err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= GRAD_RTOL, (key, err)


def test_remat_equals_no_remat():
    _, cfg, np_state = jax_state("olmoe-1b-7b")
    params = train_state_from_jax(np_state, cfg, "cpu")["params"]
    tokens = torch.from_numpy(make_batch(cfg, 2, 32)["tokens"])
    a, aux_a = forward(params, cfg, tokens, remat=False, with_aux=True)
    b, aux_b = forward(params, cfg, tokens, remat=True, with_aux=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    assert float(aux_a) == float(aux_b) > 0
    batch = ttr.batch_to_device(make_batch(cfg, 2, 32), "cpu")
    grads = [ttr.value_and_grad(params, cfg, batch, ttr.TrainConfig(
        remat=remat, compute_dtype=torch.float32))[2]
        for remat in (False, True)]
    for g, w in zip(tree_leaves(grads[0]), tree_leaves(grads[1])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)


def test_pos_offset_and_aux_match_jax():
    jcfg, cfg, np_state = jax_state("olmoe-1b-7b")
    tokens = make_batch(cfg, 2, 24)["tokens"]
    jlogits, jaux = jm.forward(jax.tree.map(jnp.asarray, np_state["params"]),
                               jcfg, jnp.asarray(tokens), pos_offset=7,
                               with_aux=True)
    params = train_state_from_jax(np_state, cfg, "cpu")["params"]
    logits, aux = forward(params, cfg, torch.from_numpy(tokens),
                          pos_offset=7, with_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_training_reduces_loss():
    """The twin of the JAX package's test: 25 steps of yi-9b smoke from the
    port's own init, bf16 compute."""
    cfg = get_smoke_config("yi-9b")
    tcfg = ttr.TrainConfig(remat=False, opt=AdamWConfig(
        lr=1e-3, warmup_steps=5, total_steps=100))
    step = ttr.make_train_step(cfg, tcfg)
    state = ttr.init_train_state(cfg, 0, tcfg, "cpu")
    it = packed_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                   batch_size=8))
    losses = []
    for _ in range(25):
        state, m = step(state, ttr.batch_to_device(next(it), "cpu"))
        losses.append(float(m["nll"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_trainer_restart_equals_the_uninterrupted_run(tmp_path):
    """A Trainer resumed from the step-3 checkpoint, fed the batches after
    it, ends where the uninterrupted run ends, to the bit; a Trainer on
    the same directory restores the latest step."""
    cfg = get_smoke_config("yi-9b")
    tcfg = ttr.TrainConfig(remat=False, microbatches=2)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4)
    batches = list(itertools.islice(packed_batches(dc), 6))
    tr = ttr.Trainer(cfg, tcfg, iter(batches), str(tmp_path / "a"),
                     checkpoint_every=3, device="cpu")
    hist = tr.run(6, log_every=1)
    assert [h["step"] for h in hist] == list(range(1, 7))
    (tmp_path / "b").mkdir()
    import shutil
    shutil.copytree(tmp_path / "a" / "step_000000003",
                    tmp_path / "b" / "step_000000003")
    tr2 = ttr.Trainer(cfg, tcfg, iter(batches[3:]), str(tmp_path / "b"),
                      device="cpu")
    assert tr2.step == 3
    hist2 = tr2.run(3, log_every=1)
    assert [h["nll"] for h in hist2] == [h["nll"] for h in hist[3:]]
    for a, b in zip(tree_leaves(tr.state), tree_leaves(tr2.state)):
        assert torch.equal(a, b)
    tr3 = ttr.Trainer(cfg, tcfg, iter(batches), str(tmp_path / "a"),
                      device="cpu")
    assert tr3.step == 6
    for a, b in zip(tree_leaves(tr.state), tree_leaves(tr3.state)):
        assert torch.equal(a, b)


def test_trainer_checkpoint_every_0_saves_only_at_the_end(tmp_path):
    """``checkpoint_every=0`` with a checkpoint directory: no periodic
    save, one at the end of ``run``."""
    cfg = get_smoke_config("yi-9b")
    tcfg = ttr.TrainConfig(remat=False, microbatches=1)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2)
    tr = ttr.Trainer(cfg, tcfg, packed_batches(dc), str(tmp_path),
                     checkpoint_every=0, device="cpu")
    tr.run(2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000002"]


def test_cast_for_compute_casts_what_jax_casts():
    """Every fp32 leaf with ndim >= 2 (the stacked gains and the MoE
    router too) becomes bf16, the rest stays; the casts carry gradients
    back to the fp32 master."""
    _, cfg, np_state = jax_state("olmoe-1b-7b")
    params = train_state_from_jax(np_state, cfg, "cpu")["params"]
    jcast = jtr.cast_for_compute(np_state["params"], jnp.bfloat16)
    cast = ttr.cast_for_compute(params, torch.bfloat16)
    for g, w in zip(tree_leaves(cast), jax.tree.leaves(jcast)):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    ttr.cast_for_compute(live, torch.bfloat16)["blocks"]["moe"][
        "router"].float().sum().backward()
    assert live["blocks"]["moe"]["router"].grad.dtype == torch.float32


def test_train_100m_twin_runs_and_resumes(tmp_path, capsys):
    args = ["--device", "cpu", "--batch", "2", "--seq", "32", "--ckpt",
            str(tmp_path)]
    hist = train_100m(["--steps", "4"] + args)
    out = capsys.readouterr().out
    assert out.startswith("model yi-20m: ")
    assert [h["step"] for h in hist] == [1]
    assert "loss " in out and "resumed" not in out
    hist = train_100m(["--steps", "11"] + args)
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 4" in out
    assert [h["step"] for h in hist] == [10]
    assert all(np.isfinite(h["nll"]) for h in hist)


def test_config_train_100m_is_the_jax_examples():
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "jax_train_100m", pathlib.Path(__file__).resolve().parents[1]
        / "examples" / "train_100m.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    from repro_torch.train_100m import build_config
    for full in (False, True):
        assert dataclasses.asdict(build_config(full)) == dataclasses.asdict(
            module.build_config(full))
