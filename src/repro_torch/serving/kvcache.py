"""Paged KV cache (vLLM-style) with device-resident decode metadata.

Storage: ``BlockPool`` owns the layer-stacked pools ``k/v: [L,
num_blocks + 1, Hkv, block, D]`` in kernel-native layout (the paged-decode
kernel and its plain version read ``[page, Hkv, block, D]`` tiles without a
transpose) plus the host-side ``BlockAllocator``.  Physical block
``num_blocks`` is a trash page: padded batch rows write their dummy K/V
there, so the decode step needs no masking branches.  ``D`` is the model's
head_dim; nothing is padded.  An attention-free model (mamba2) has no K/V
pools, but keeps the allocator and block accounting, as in the JAX
package.

A ``PagedKVCache`` is one replica's view of a pool: per-slot block tables,
sequence lengths and, for models with SSM layers, device rows per slot:
``ssm [L, max_seqs + 1, H, P, N]`` (fp32) and ``conv [L, max_seqs + 1,
W - 1, conv_ch]`` (pool dtype), with the trash row last.  Prefill writes a
slot's rows; the decode loop gathers the batch's rows and scatters them
back.  ``create`` builds a private pool and a view over it;
``from_pool`` attaches a view to a pool that several engines share, with a
block ``quota`` so one view cannot starve the others.

Admission reserves a sequence's full lifetime block count (prompt + decode
growth) against both the view's quota and the pool (``BlockPool.reserved``),
so later ``extend_for`` calls draw from already-reserved capacity.  The
host ``block_table``/``seq_lens`` (numpy) are the scheduler's truth; the
device mirrors ``block_table_dev [max_seqs + 1, max_blocks_per_seq]``
(initialised to the trash page) and ``seq_lens_dev [max_seqs + 1]`` are
updated incrementally — one small scatter on admit / page crossing /
release.  Row ``max_seqs`` is the trash slot used to pad decode batches to
bucket sizes.

Block ids and tables mean the same thing as in the JAX package.  Where the
JAX package replaces its pool arrays functionally, this port writes the
pool and mirror tensors in place (``index_put_`` / slice assignment), so
every view of a shared pool sees every write at once.
``gather_dense`` and ``write_token`` serve the engine's dense decode mode:
they copy the batch's live K/V out of the pages into a dense cache and the
step's new token back.

Migration primitives (``repro_torch.serving.migration`` builds on these):
``disown_slot`` takes a sequence out of a view's accounting without
returning its blocks to the allocator, so a sibling view over the same pool
can ``adopt_slot`` them — the pages do not move.  ``copy_blocks`` moves
pages between pools of the same geometry; ``gather_tokens`` +
``scatter_tokens`` (``relayout_blocks``) move a sequence between pools
whose page size differs.

Prefix sharing (``repro_torch.serving.prefixcache`` builds on these):
``admit`` can attach pages already in the pool by reference count
(``shared_blocks``) and copy a partly matched page into a private one
(``cow_src``).  A shared page is counted once: it stays out of every view's
reservation and ``used_blocks``, and every teardown path (``release_slot``,
``disown_slot``, migration) drops one reference through
``BlockAllocator.release`` instead of freeing, so a page lives while any
sequence or the cache's index holds it.  A ``PrefixCache`` set as
``BlockPool.prefix_cache`` is asked to evict cold cached pages to host
memory when an allocation finds the free list short (``BlockPool.reclaim``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import conv_channels


class BlockAllocator:
    """Host-side free-list of physical blocks with reference counts, in the
    JAX package's order: ``alloc`` pops from the end, a block whose last
    reference drops is appended."""

    def __init__(self, num_blocks: int):
        self.free = list(range(num_blocks - 1, -1, -1))
        self.refs = np.zeros(num_blocks, np.int32)
        # blocks held by more than one owner (shared prefix pages): they
        # take physical room outside any one sequence's reservation, so
        # the views' headroom subtracts them (``n_free_blocks``)
        self.pinned = 0

    def alloc(self, n: int) -> list[int]:
        if len(self.free) < n:
            raise MemoryError(f"KV pool exhausted (need {n}, "
                              f"have {len(self.free)})")
        out = [self.free.pop() for _ in range(n)]
        for b in out:
            self.refs[b] = 1
        return out

    def release(self, blocks: list[int]) -> None:
        """Drop one reference to each block; a block returns to the free
        list only when its last reference goes."""
        for b in blocks:
            self.refs[b] -= 1
            if self.refs[b] == 1:
                self.pinned -= 1
            if self.refs[b] <= 0:
                self.refs[b] = 0
                self.free.append(b)

    def share(self, blocks: list[int]) -> None:
        """Take one more reference to each block (prefix sharing)."""
        for b in blocks:
            self.refs[b] += 1
            if self.refs[b] == 2:
                self.pinned += 1

    @property
    def n_free(self) -> int:
        return len(self.free)


class BlockPool:
    """Device K/V block pool (none for an attention-free model) +
    allocator, shareable by several engines' cache views.

    ``reserved`` counts the blocks promised to admitted sequences over all
    views; ``PagedKVCache.n_free_blocks`` reserves against it."""

    def __init__(self, cfg: ModelConfig, num_blocks: int,
                 block_size: int = 16, dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.dtype = dtype
        self.device = torch.device(device)
        self.k = self.v = None
        if cfg.has_attn:
            shape = (cfg.n_layers, num_blocks + 1, cfg.n_kv_heads,
                     block_size, cfg.head_dim)
            self.k = torch.zeros(shape, dtype=dtype, device=self.device)
            self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.allocator = BlockAllocator(num_blocks)
        self.reserved = 0           # blocks promised to admitted sequences
        self.prefix_cache = None    # set by PrefixCache.__init__

    def reclaim(self, n: int) -> None:
        """Make room for an ``n``-block allocation by evicting cold cached
        pages to the host tier (nothing without a prefix cache, or while
        the free list covers ``n``)."""
        if self.prefix_cache is not None and self.allocator.n_free < n:
            self.prefix_cache.reclaim(n)

    @property
    def trash_page(self) -> int:
        return self.num_blocks

    @property
    def page_nbytes(self) -> int:
        """Bytes one page holds in k and v over all layers (0 for an
        attention-free pool); the host tier's transfers are this size."""
        if self.k is None:
            return 0
        return 2 * self.k[:, 0].numel() * self.k.element_size()


@dataclasses.dataclass
class PagedKVCache:
    cfg: ModelConfig
    block_size: int
    num_blocks: int             # pool-wide physical block count
    max_seqs: int
    max_blocks_per_seq: int
    pool: BlockPool
    block_table: np.ndarray     # host [max_seqs, max_blocks_per_seq] int32
    seq_lens: np.ndarray        # host [max_seqs] int32
    block_table_dev: torch.Tensor  # device [max_seqs + 1, max_blocks_per_seq]
    seq_lens_dev: torch.Tensor     # device [max_seqs + 1]
    seq_blocks: dict            # slot -> list[int]
    quota: int | None = None    # shared pool: this view's block budget
    used_blocks: int = 0
    reserved_blocks: int = 0    # admitted sequences' lifetime reservations
    seq_reserved: dict = dataclasses.field(default_factory=dict)
    # slot -> leading prefix-cache pages held by reference (counted once
    # pool-wide: outside this view's used and reserved counts)
    seq_shared: dict = dataclasses.field(default_factory=dict)
    ssm: torch.Tensor | None = None     # [L, max_seqs + 1, H, P, N] fp32
    conv: torch.Tensor | None = None    # [L, max_seqs + 1, W - 1, conv_ch]

    @classmethod
    def create(cls, cfg: ModelConfig, num_blocks: int = 256,
               block_size: int = 16, max_seqs: int = 16,
               max_blocks_per_seq: int = 64, dtype=torch.float32,
               device="cuda") -> "PagedKVCache":
        """A cache over a private pool."""
        pool = BlockPool(cfg, num_blocks, block_size, dtype, device)
        return cls.from_pool(pool, max_seqs, max_blocks_per_seq)

    @classmethod
    def from_pool(cls, pool: BlockPool, max_seqs: int,
                  max_blocks_per_seq: int,
                  quota: int | None = None) -> "PagedKVCache":
        """A view over a (possibly shared) pool, with its own tables,
        mirrors and SSM/conv rows.  ``quota`` caps the blocks this view may
        reserve at once; None means the whole pool."""
        cfg = pool.cfg
        # device tables start at the trash page so un-admitted / padded rows
        # read and write only the trash page
        table_dev = torch.full((max_seqs + 1, max_blocks_per_seq),
                               pool.trash_page, dtype=torch.int32,
                               device=pool.device)
        lens_dev = torch.zeros(max_seqs + 1, dtype=torch.int32,
                               device=pool.device)
        ssm = conv = None
        if cfg.has_ssm:
            L = cfg.n_layers
            ssm = torch.zeros((L, max_seqs + 1, cfg.ssm_heads,
                               cfg.ssm_head_dim, cfg.ssm_state),
                              dtype=torch.float32, device=pool.device)
            conv = torch.zeros((L, max_seqs + 1, cfg.ssm_conv_width - 1,
                                conv_channels(cfg)), dtype=pool.dtype,
                               device=pool.device)
        return cls(cfg, pool.block_size, pool.num_blocks, max_seqs,
                   max_blocks_per_seq, pool,
                   np.zeros((max_seqs, max_blocks_per_seq), np.int32),
                   np.zeros(max_seqs, np.int32), table_dev, lens_dev, {},
                   quota, ssm=ssm, conv=conv)

    # -- pool delegation ------------------------------------------------------

    @property
    def k(self) -> torch.Tensor | None:
        return self.pool.k

    @property
    def v(self) -> torch.Tensor | None:
        return self.pool.v

    @property
    def allocator(self) -> BlockAllocator:
        return self.pool.allocator

    @property
    def device(self) -> torch.device:
        return self.pool.device

    @property
    def n_free_blocks(self) -> int:
        """Blocks this view may still reserve: the pool's blocks neither
        reserved nor pinned (shared by several owners), capped by what is
        left of the view's quota.  Cold cached pages count as free: they
        are evicted on demand (``BlockPool.reclaim``)."""
        n = (self.pool.num_blocks - self.pool.reserved
             - self.pool.allocator.pinned)
        if self.quota is not None:
            n = min(n, self.quota - self.reserved_blocks)
        return n

    def _blocks(self, tokens: int) -> int:
        return (tokens + self.block_size - 1) // self.block_size

    @property
    def trash_slot(self) -> int:
        """Device table/lens row used to pad decode batches to bucket size."""
        return self.max_seqs

    # -- slot lifecycle -------------------------------------------------------

    def admit(self, slot: int, prompt_len: int, total_tokens: int,
              shared_blocks: tuple | list = (),
              cow_src: int | None = None) -> None:
        """Admit one sequence: allocate its prompt blocks now and reserve its
        full lifetime block count (``total_tokens`` = prompt + decode
        growth) so its decode growth can never fail.

        ``shared_blocks`` are prefix-cache pages covering the sequence's
        leading full pages: attached by reference, not allocated, and kept
        out of the reservation.  ``cow_src`` is a cached page the sequence
        diverges inside; it is copied into the first fresh page, so no
        write touches the shared original."""
        n = self._blocks(prompt_len)
        s = len(shared_blocks)
        fresh = n - s
        reserve = max(n, self._blocks(total_tokens)) - s
        self.pool.reclaim(fresh)
        new_blocks = self.allocator.alloc(fresh)
        self.allocator.share(list(shared_blocks))
        if cow_src is not None:
            copy_blocks(self.pool, self.pool, [cow_src], [new_blocks[0]])
        self.used_blocks += fresh
        self._register(slot, list(shared_blocks) + new_blocks, prompt_len,
                       reserve, s)

    def _register(self, slot: int, blocks: list[int], seq_len: int,
                  reserve: int, n_shared: int = 0) -> None:
        """Book ``reserve`` blocks against the view and the pool and write
        the slot's host and device table rows; the first ``n_shared``
        blocks are held by reference."""
        self.reserved_blocks += reserve
        self.pool.reserved += reserve
        self.seq_reserved[slot] = reserve
        if n_shared:
            self.seq_shared[slot] = n_shared
        self.seq_blocks[slot] = list(blocks)
        n = len(blocks)
        self.block_table[slot, :] = 0
        self.block_table[slot, :n] = blocks
        self.seq_lens[slot] = seq_len
        # incremental device sync: one row write per admission
        row = np.full(self.max_blocks_per_seq, self.num_blocks, np.int32)
        row[:n] = blocks
        self.block_table_dev[slot] = torch.from_numpy(row).to(self.device)
        self.seq_lens_dev[slot] = seq_len

    def can_admit(self, prompt_len: int, total_tokens: int,
                  shared_blocks: tuple | list = ()) -> bool:
        """Whether the lifetime reservation of a sequence of ``total_tokens``
        (prompt + expected decode growth) fits in the unreserved blocks.

        ``shared_blocks`` (the cached pages the admission would attach) are
        resident already and shrink the need, but each one still cold (held
        by the index alone) leaves the evictable set when attached, so its
        first sharer pays for it once."""
        refs = self.allocator.refs
        pin = sum(1 for b in shared_blocks if refs[b] == 1)
        need = (max(self._blocks(prompt_len), self._blocks(total_tokens))
                - len(shared_blocks) + pin)
        return self.n_free_blocks >= need

    def extend_for(self, slot: int, n_tokens: int) -> tuple | None:
        """Ensure page capacity for the next ``n_tokens`` decode tokens.

        The horizon pre-extend: every block the decode loop will write
        through the block table (positions ``len .. len + n_tokens - 1``) is
        allocated here in one host pass, out of the slot's admission
        reservation.  The host length advances here; the device
        ``seq_lens_dev`` row advances with the decode loop.

        Returns the pending device table update ``(slot, first_col,
        new_blocks)``, or None, so a batch caller applies all slots'
        updates in one scatter (``apply_table_updates``).
        """
        new_len = int(self.seq_lens[slot]) + n_tokens
        n_have = len(self.seq_blocks[slot])
        need = (new_len + self.block_size - 1) // self.block_size
        update = None
        if need > n_have:
            # the reservation covers the sequence's private pages only
            if need - self.seq_shared.get(slot, 0) > self.seq_reserved[slot]:
                raise MemoryError("sequence grew beyond its admission "
                                  "reservation")
            grow = need - n_have
            self.pool.reclaim(grow)
            new_blocks = self.allocator.alloc(grow)
            self.used_blocks += grow
            self.seq_blocks[slot].extend(new_blocks)
            self.block_table[slot, n_have:need] = new_blocks
            update = (slot, n_have, new_blocks)
        self.seq_lens[slot] = new_len
        return update

    def apply_table_updates(self, updates: list[tuple]) -> None:
        """Apply deferred ``extend_for`` device updates in one scatter."""
        if not updates:
            return
        rows, cols, vals = [], [], []
        for slot, start, blocks in updates:
            rows.extend([slot] * len(blocks))
            cols.extend(range(start, start + len(blocks)))
            vals.extend(blocks)
        idx = torch.tensor([rows, cols], dtype=torch.long, device=self.device)
        self.block_table_dev.index_put_(
            (idx[0], idx[1]),
            torch.tensor(vals, dtype=torch.int32, device=self.device))

    def release_slot(self, slot: int) -> None:
        """Drop the slot's reference to each of its pages: a shared page,
        or one the cache's index holds, outlives it."""
        self.allocator.release(self._unregister(slot))

    def release_all(self) -> None:
        """Return every block this view holds to the pool (teardown)."""
        for slot in list(self.seq_blocks):
            self.release_slot(slot)

    def _unregister(self, slot: int) -> list[int]:
        """Take a slot out of the view's and the pool's accounting and
        reset its table rows; returns its blocks, still allocated."""
        blocks = self.seq_blocks.pop(slot, [])
        s = self.seq_shared.pop(slot, 0)
        self.used_blocks -= len(blocks) - s
        reserve = self.seq_reserved.pop(slot, len(blocks) - s)
        self.reserved_blocks -= reserve
        self.pool.reserved -= reserve
        self.seq_lens[slot] = 0
        self.block_table[slot, :] = 0
        self.block_table_dev[slot] = self.num_blocks
        self.seq_lens_dev[slot] = 0
        return blocks

    # -- ownership transfer (page handoff between views) -----------------------

    def disown_slot(self, slot: int) -> tuple[list[int], int]:
        """Take a sequence out of this view's accounting without releasing
        its blocks to the allocator.

        Returns ``(blocks, seq_len)``.  The caller now holds the slot's
        references to the pages; they must end in ``adopt_slot`` on a view
        of the same pool or in the allocator's ``release``, or the pool
        leaks.  Read ``seq_shared`` first to carry the shared count.
        """
        seq_len = int(self.seq_lens[slot])
        blocks = self.seq_blocks[slot]      # KeyError for an empty slot
        self._unregister(slot)
        return blocks, seq_len

    def can_adopt(self, n_blocks: int, total_tokens: int,
                  n_shared: int = 0) -> bool:
        return (self.n_free_blocks
                >= max(n_blocks, self._blocks(total_tokens)) - n_shared)

    def adopt_slot(self, slot: int, blocks: list[int], seq_len: int,
                   total_tokens: int | None = None,
                   n_shared: int = 0) -> None:
        """Adopt already-allocated blocks of this view's pool into a slot:
        the inverse of ``disown_slot``.  The data stays where it is; only
        the accounting and the (host + device) table rows move.  The first
        ``n_shared`` blocks are prefix-cache pages held by reference,
        counted once pool-wide and so kept out of this view's counts."""
        n = len(blocks)
        if n > self.max_blocks_per_seq:
            raise MemoryError("adopted sequence exceeds max_blocks_per_seq")
        total = total_tokens or seq_len
        reserve = max(n, self._blocks(total)) - n_shared
        if not self.can_adopt(n, total, n_shared):
            raise MemoryError(
                f"cannot adopt {n} blocks (reserve {reserve}): view has "
                f"{self.n_free_blocks} free")
        self.used_blocks += n - n_shared
        self._register(slot, blocks, seq_len, reserve, n_shared)

    # -- device writes ---------------------------------------------------------

    def write_prefill(self, slot: int, k_seq: torch.Tensor,
                      v_seq: torch.Tensor) -> None:
        """k_seq/v_seq: [L, S, Hkv, D] from prefill; written into the
        slot's pages in place."""
        scatter_tokens(self.pool, self.seq_blocks[slot], k_seq, v_seq)

    def write_token(self, slots: np.ndarray, k_new: torch.Tensor,
                    v_new: torch.Tensor, positions: np.ndarray) -> None:
        """k_new/v_new: [L, B, Hkv, D], one token per slot, written at
        ``positions`` [B] into the slots' pages in place."""
        bs = self.block_size
        dev = self.device
        blk = torch.as_tensor(self.block_table[slots, positions // bs],
                              dtype=torch.long, device=dev)
        off = torch.as_tensor(positions % bs, dtype=torch.long, device=dev)
        L, _, Hkv, _ = k_new.shape
        # pool [L, P, Hkv, block, D]; the index broadcasts to [B, L, Hkv]
        idx = (torch.arange(L, device=dev)[None, :, None], blk[:, None, None],
               torch.arange(Hkv, device=dev)[None, None, :],
               off[:, None, None])
        self.k.index_put_(idx, k_new.transpose(0, 1).to(self.k.dtype))
        self.v.index_put_(idx, v_new.transpose(0, 1).to(self.v.dtype))

    def gather_dense(self, slots: np.ndarray, max_len: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The slots' positions [0, max_len) copied out of their pages into
        contiguous dense caches [L, B, max_len, Hkv, D] (one gather per
        pool), and their lengths [B].  Positions past a slot's allocated
        pages read whatever block its host table row names there; they lie
        at or past the slot's length, where decode masks them."""
        bs = self.block_size
        dev = self.device
        n_blocks = (max_len + bs - 1) // bs
        table = torch.as_tensor(self.block_table[slots, :n_blocks],
                                dtype=torch.long, device=dev)   # [B, n]
        pos = torch.arange(max_len, device=dev)
        L, _, Hkv, _, _ = self.k.shape
        idx = (torch.arange(L, device=dev)[:, None, None, None],
               table[:, pos // bs][None, :, :, None],
               torch.arange(Hkv, device=dev)[None, None, None, :],
               (pos % bs)[None, None, :, None])
        lens = torch.as_tensor(self.seq_lens[slots], dtype=torch.int32,
                               device=dev)
        return self.k[idx], self.v[idx], lens


# --------------------------------------------------------------------------
# Pool-to-pool page movement (cross-pool KV migration).
#
# Plain tensor indexing, in place, as the JAX package computes these with
# jnp outside any kernel.  The JAX package pads the index vectors to a
# power of two only to bound its jit compilations; eager indexing compiles
# nothing, so the port passes the vectors as they are.  An index on the
# right-hand side gathers a copy, so a destination page never aliases its
# source.
# --------------------------------------------------------------------------


def copy_blocks(src: BlockPool, dst: BlockPool,
                src_blocks: list[int], dst_blocks: list[int]) -> None:
    """Copy pages between two pools of the same geometry."""
    if (src.block_size != dst.block_size
            or src.k.shape[2:] != dst.k.shape[2:]):
        raise ValueError("copy_blocks needs matching page geometry; use "
                         "relayout_blocks")
    if len(src_blocks) != len(dst_blocks):
        raise ValueError("src/dst block lists differ in length")
    if not src_blocks:
        return
    src_idx = torch.tensor(src_blocks, dtype=torch.long, device=src.device)
    dst_idx = torch.tensor(dst_blocks, dtype=torch.long, device=dst.device)
    dst.k[:, dst_idx] = src.k[:, src_idx].to(dst.k.dtype)
    dst.v[:, dst_idx] = src.v[:, src_idx].to(dst.v.dtype)


def gather_tokens(pool: BlockPool, blocks: list[int], seq_len: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One sequence's K/V as dense copies [L, seq_len, Hkv, D]."""
    idx = torch.tensor(blocks, dtype=torch.long, device=pool.device)
    k = pool.k[:, idx]                       # [L, n, Hkv, bs, D]
    v = pool.v[:, idx]
    L, n, H, bs, D = k.shape
    k = k.transpose(2, 3).reshape(L, n * bs, H, D)[:, :seq_len]
    v = v.transpose(2, 3).reshape(L, n * bs, H, D)[:, :seq_len]
    return k, v


def scatter_tokens(pool: BlockPool, blocks: list[int],
                   k_seq: torch.Tensor, v_seq: torch.Tensor) -> None:
    """Write dense [L, S, Hkv, D] K/V into the given pages of ``pool``,
    re-chunked to its page size."""
    L, S, H, D = k_seq.shape
    bs = pool.block_size
    n = (S + bs - 1) // bs
    if n != len(blocks):
        raise ValueError(f"{S} tokens need {n} blocks, got {len(blocks)}")
    pad = n * bs - S
    if pad:
        k_seq = torch.nn.functional.pad(k_seq, (0, 0, 0, 0, 0, pad))
        v_seq = torch.nn.functional.pad(v_seq, (0, 0, 0, 0, 0, pad))
    kb = k_seq.reshape(L, n, bs, H, D).transpose(2, 3)   # [L, n, H, bs, D]
    vb = v_seq.reshape(L, n, bs, H, D).transpose(2, 3)
    idx = torch.tensor(blocks, dtype=torch.long, device=pool.device)
    pool.k[:, idx] = kb.to(pool.k.dtype)
    pool.v[:, idx] = vb.to(pool.v.dtype)


def relayout_blocks(src: BlockPool, dst: BlockPool,
                    src_blocks: list[int], dst_blocks: list[int],
                    seq_len: int) -> None:
    """Move one sequence between pools whose page size differs: dense
    gather, then re-chunked scatter, on the device."""
    k, v = gather_tokens(src, src_blocks, seq_len)
    scatter_tokens(dst, dst_blocks, k, v)
