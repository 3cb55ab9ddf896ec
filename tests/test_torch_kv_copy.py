"""The port's shared-pool accounting and page-movement primitives against
the JAX package's ``serving/kvcache.py``.

Two quota'd views over one pool admit, grow, disown and adopt sequences in
the same order in both packages; after every operation the views' and the
pool's counts, the free list and the host and device table rows must be
equal.  ``copy_blocks``, ``gather_tokens``, ``scatter_tokens`` and
``relayout_blocks`` move seeded pool contents, fp32 and bf16; they only
move values, so the results must be equal exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.serving import kvcache as jkv
from repro_torch.configs import get_smoke_config
from repro_torch.serving import kvcache as tkv

ARCH = "yi-9b"


def _views(package, num_blocks=24, quotas=(14, 12)):
    """A pool of 8-token pages and two views over it with ``quotas``."""
    if package == "jax":
        pool = jkv.BlockPool(jax_smoke_config(ARCH), num_blocks, 8)
        cls = jkv.PagedKVCache
    else:
        pool = tkv.BlockPool(get_smoke_config(ARCH), num_blocks, 8,
                             device="cpu")
        cls = tkv.PagedKVCache
    return pool, [cls.from_pool(pool, 4, 8, quota=q) for q in quotas]


def _state(pool, views):
    return dict(
        pool_reserved=pool.reserved, free=list(pool.allocator.free),
        views=[dict(used=v.used_blocks, reserved=v.reserved_blocks,
                    n_free=v.n_free_blocks, seq_reserved=dict(v.seq_reserved),
                    seq_blocks={s: list(b) for s, b in v.seq_blocks.items()},
                    table=v.block_table.tolist(),
                    lens=v.seq_lens.tolist(),
                    table_dev=np.asarray(v.block_table_dev).tolist(),
                    lens_dev=np.asarray(v.seq_lens_dev).tolist())
               for v in views])


def _extend(view, slot, n):
    """``extend_for`` with its device sync, in either package."""
    if isinstance(view, tkv.PagedKVCache):
        view.apply_table_updates([u for u in [view.extend_for(slot, n)]
                                  if u is not None])
    else:
        view.extend_for(slot, n)


def _ownership_script(package):
    """Admit on view A, grow, disown, adopt on view B (twice, once refused
    by B's quota), release; the state after each operation."""
    pool, (a, b) = _views(package)
    states = [_state(pool, (a, b))]

    def record(*extra):
        states.append((_state(pool, (a, b)),) + extra)

    a.admit(0, 20, total_tokens=30)          # 3 blocks now, 4 reserved
    record()
    a.admit(1, 9, total_tokens=12)
    record()
    _extend(a, 0, 9)                         # 29 tokens: the 4th block
    record()
    b.admit(2, 5, total_tokens=7)
    record()
    blocks, seq_len = a.disown_slot(0)
    record(list(blocks), seq_len)
    record(b.can_adopt(len(blocks), seq_len + 6))
    b.adopt_slot(0, blocks, seq_len, total_tokens=seq_len + 6)
    record()
    _extend(b, 0, 6)
    record()
    # B has 12 - 6 = 6 blocks of quota left: a 10-block reservation is
    # refused, and the refusal changes nothing
    blocks, seq_len = a.disown_slot(1)
    record(b.can_adopt(len(blocks), 80))
    with pytest.raises(MemoryError):
        b.adopt_slot(1, blocks, seq_len, total_tokens=80)
    record()
    a.adopt_slot(3, blocks, seq_len, total_tokens=12)
    record()
    a.release_all()
    b.release_all()
    record()
    return states


def test_ownership_transfer_matches_jax():
    got = _ownership_script("torch")
    want = _ownership_script("jax")
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"after operation {i}"
    final = got[-1][0]
    assert final["pool_reserved"] == 0 and sorted(final["free"]) == list(
        range(24))


def test_quota_and_pool_bound_admission_match_jax():
    """``n_free_blocks`` is the pool's unreserved count capped by the
    view's quota left: a view is bound by its quota while the pool has
    room, and by the pool once its sibling has reserved most of it."""
    out = {}
    for package in ("jax", "torch"):
        pool, (a, b) = _views(package, num_blocks=16, quotas=(12, 12))
        seen = [(a.n_free_blocks, b.n_free_blocks)]
        a.admit(0, 40, total_tokens=80)      # 10 blocks reserved
        seen.append((a.n_free_blocks, b.n_free_blocks,
                     b.can_admit(30, total_tokens=40),
                     b.can_admit(30, total_tokens=56)))
        a.release_slot(0)
        seen.append((a.n_free_blocks, b.n_free_blocks, pool.reserved))
        out[package] = seen
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == (2, 6, True, False)


def _pools(package, dtype, specs, seed=0):
    """Pools of the given (num_blocks, block_size), filled with the same
    seeded values in both packages (bf16 values are exact in both)."""
    rng = np.random.RandomState(seed)
    out = []
    for n, bs in specs:
        if package == "jax":
            jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
            pool = jkv.BlockPool(jax_smoke_config(ARCH), n, bs, jd)
        else:
            pool = tkv.BlockPool(get_smoke_config(ARCH), n, bs, dtype,
                                 device="cpu")
        vals = []
        for _ in range(2):
            x = torch.from_numpy(
                rng.standard_normal(pool.k.shape).astype(np.float32))
            vals.append(x.to(dtype))
        if package == "jax":
            pool.k, pool.v = (jnp.asarray(x.float().numpy()).astype(
                pool.k.dtype) for x in vals)
        else:
            pool.k.copy_(vals[0])
            pool.v.copy_(vals[1])
        out.append(pool)
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


SRC_BLOCKS = [3, 1, 7]
SEQ_LEN = 21


def _moves(package, dtype):
    """Each primitive on fresh seeded pools; the arrays it produced."""
    mod = jkv if package == "jax" else tkv
    out = {}
    src, dst = _pools(package, dtype, [(12, 8), (12, 8)])
    mod.copy_blocks(src, dst, SRC_BLOCKS, [0, 5, 2])
    # the JAX package pads its index vectors with the trash pages, so it
    # also copies the source's trash page onto the destination's; the
    # trash page holds no sequence's data
    out["copy"] = (_np(dst.k)[:, :-1], _np(dst.v)[:, :-1])
    src, = _pools(package, dtype, [(12, 8)])
    k, v = mod.gather_tokens(src, SRC_BLOCKS, SEQ_LEN)
    out["gather"] = (_np(k), _np(v))
    src, dst = _pools(package, dtype, [(12, 8), (12, 8)], seed=1)
    k, v = mod.gather_tokens(src, SRC_BLOCKS, SEQ_LEN)
    mod.scatter_tokens(dst, [9, 4, 6], k, v)
    out["scatter"] = (_np(dst.k), _np(dst.v))
    src, dst = _pools(package, dtype, [(12, 8), (16, 4)], seed=2)
    mod.relayout_blocks(src, dst, SRC_BLOCKS, [2, 11, 0, 8, 5, 14], SEQ_LEN)
    out["relayout-to-4"] = (_np(dst.k), _np(dst.v))
    src, dst = _pools(package, dtype, [(16, 4), (12, 16)], seed=3)
    mod.relayout_blocks(src, dst, [5, 0, 9, 2, 12, 1], [4, 10], SEQ_LEN)
    out["relayout-to-16"] = (_np(dst.k), _np(dst.v))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["copy", "gather", "scatter", "relayout-to-4",
                                "relayout-to-16"])
def test_page_movement_matches_jax_exactly(op, dtype):
    got = _moves("torch", dtype)[op]
    want = _moves("jax", dtype)[op]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_copy_does_not_alias_the_source(dtype):
    """A copied page is the destination's own: writing the source page
    afterwards leaves it unchanged."""
    src, dst = _pools("torch", dtype, [(12, 8), (12, 8)])
    tkv.copy_blocks(src, dst, [3], [0])
    before = dst.k[:, 0].clone()
    src.k[:, 3] = 0
    assert torch.equal(dst.k[:, 0], before)
    k, _ = tkv.gather_tokens(src, [3], 8)
    assert not k.any()
    assert torch.equal(tkv.gather_tokens(dst, [0], 8)[0],
                       before.transpose(1, 2))


def test_copy_needs_matching_geometry():
    src, dst = _pools("torch", torch.float32, [(12, 8), (16, 4)])
    with pytest.raises(ValueError):
        tkv.copy_blocks(src, dst, [1], [2])
    with pytest.raises(ValueError):
        tkv.scatter_tokens(dst, [1], *tkv.gather_tokens(src, [1, 2], 9))
