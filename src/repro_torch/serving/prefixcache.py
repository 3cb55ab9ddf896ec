"""Content-addressed prefix cache and host-tiered KV store over a BlockPool.

The port of the JAX package's ``serving/prefixcache.py``, with the same
keys, index, counters and eviction order.

**Prefix reuse.**  ``PrefixCache`` indexes full, page-aligned chunks of
token streams by a chained content hash: page ``i``'s key is
``H(key[i-1] || tokens[i*bs:(i+1)*bs])``, so a key names the page's
content and its whole prefix, and two prompts share a cached page iff they
are token-identical up to and including it.  At admission the engine walks
the prompt's chain through the index (``match``, then ``attach``) and
attaches every matched page to the sequence by reference count
(``BlockAllocator.share``): no bytes move, no token is recomputed, and
prefill resumes at the first uncached token.  When the match covers the
whole prompt, the last matched page comes back as a copy-on-write source:
the sequence diverges inside it (its last prompt token, and decode after
it, are written mid-page), so the page is copied into a private block at
admission and the shared original stays as it was.  Shared pages are never
written: prefill resumes past them, and decode writes only positions
``>= prompt_len``, which land in the copied page or in later private ones.

**Reference counts.**  Every index entry whose page is on the device holds
one allocator reference to it (taken by ``publish`` or a restore); each
sequence that attaches the page holds one more (``share`` at admission,
dropped by ``release_slot``).  A page is cold when its count is exactly 1,
the index's own.  A sequence publishes its pages before it releases them,
so they outlive it at count 1 instead of going back to the free list.

**Host tier.**  When an allocation finds the free list short
(``BlockPool.reclaim``), the cache evicts cold pages, least recently used
first, to host memory and frees their blocks.  A host copy is one CPU
tensor ``[2, L, bs, Hkv, D]`` (k then v, ``gather_tokens``' dense layout),
in pinned memory when the pool lives on the card, so that an eviction and a
restore are one DMA each.  The eviction's copy is synchronous: the bytes
are on the host before the block goes back to the allocator.  A later
``attach`` hit on a host entry restores it into a fresh block.

The cache belongs to the pool: engines sharing one ``BlockPool`` share one
index.  ``telemetry`` is its event sink (an engine built with an enabled
``serving.telemetry.Telemetry`` sets it): each eviction and restore emits
an ``evict``/``restore`` event of one page and its bytes, with replica -1,
as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.serving.kvcache import BlockPool, gather_tokens, scatter_tokens


def _page_key(parent: bytes, chunk: np.ndarray) -> bytes:
    """Chained content hash of one full page of tokens."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.ascontiguousarray(chunk, np.int32).tobytes())
    return h.digest()


@dataclasses.dataclass
class _Entry:
    """One cached page: on the device (``block``) or on the host (``host``)."""
    key: bytes
    block: int | None                 # physical pool page; None = evicted
    host: torch.Tensor | None = None  # [2, L, bs, Hkv, D] k and v, CPU
    tick: int = 0                     # LRU clock at last touch


@dataclasses.dataclass
class PrefixMatch:
    """A walk of one prompt through the index (no side effects yet)."""
    cached_tokens: int                # tokens the cache can provide (< prompt)
    keys: list                        # matched entry keys, page order
    cow: bool                         # last matched page must be copied


class PrefixCache:
    """Content-addressed page index and host tier for one ``BlockPool``.

    ``PrefixCache(pool)`` attaches itself to the pool, whose ``reclaim``
    then evicts cold pages when an allocation finds the free list short.
    Everything here is host bookkeeping except an eviction's and a
    restore's copies.
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        pool.prefix_cache = self
        self.index: dict[bytes, _Entry] = {}
        self._tick = 0
        # monotonic counters
        self.hits = 0                 # admissions that reused >= 1 page
        self.misses = 0               # admissions with no cached prefix
        self.hit_tokens = 0           # prompt tokens served from the cache
        self.published_pages = 0
        self.evicted_bytes = 0        # device -> host tier
        self.restored_bytes = 0       # host tier -> device
        self.dropped_pages = 0        # cold pages freed without a host copy
        # event sink for evict/restore (pool-scoped: replica -1)
        self.telemetry = None

    # -- lookup / attach -------------------------------------------------------

    def match(self, tokens: np.ndarray, limit: int) -> PrefixMatch:
        """Walk the prompt's page chain through the index; changes nothing.

        ``limit`` caps the cached length (callers pass ``prompt_len - 1``,
        so the last prompt token always goes through a prefill forward,
        whose logits give the first generated token).  A cap that lands
        mid-page marks the last matched page copy-on-write.
        """
        bs = self.pool.block_size
        keys: list[bytes] = []
        parent = b""
        for i in range(len(tokens) // bs):
            if len(keys) * bs >= limit:
                break
            key = _page_key(parent, tokens[i * bs:(i + 1) * bs])
            if key not in self.index:
                break
            keys.append(key)
            parent = key
        if not keys:
            return PrefixMatch(0, [], False)
        cached = min(len(keys) * bs, limit)
        return PrefixMatch(cached, keys, bool(cached % bs))

    def attach(self, m: PrefixMatch) -> tuple[int, list[int], int | None]:
        """Realise a match: restore host entries, return the blocks to
        attach.

        Returns ``(cached_tokens, shared_blocks, cow_src)``: the caller
        (``PagedKVCache.admit``) takes a reference to each shared block and
        copies ``cow_src`` (a block id, or None) into a private page.  A
        host entry that cannot be restored (no block free even after
        eviction) ends the match there, and the rest is recomputed.  No
        reference moves here, so an admission that fails after ``attach``
        leaves the index as it was.
        """
        bs = self.pool.block_size
        blocks: list[int] = []
        for key in m.keys:
            e = self.index.get(key)
            if e is None:
                break
            if e.block is None:
                try:
                    self._restore(e)
                except MemoryError:
                    break
            self._tick += 1
            e.tick = self._tick
            blocks.append(e.block)
        cached = min(len(blocks) * bs, m.cached_tokens)
        if cached <= 0:
            self.misses += 1
            return 0, [], None
        n_shared = cached // bs
        # the sequence diverges inside the last matched page: attach it by
        # copy, not by reference
        cow_src = blocks[n_shared] if cached % bs else None
        self.hits += 1
        self.hit_tokens += cached
        return cached, blocks[:n_shared], cow_src

    # -- publish ---------------------------------------------------------------

    def publish(self, tokens: np.ndarray, blocks: list[int]) -> int:
        """Index every full page of ``tokens`` held in ``blocks``.

        Called when a sequence's context is all in pages (end of prefill)
        and again at retirement, when decode has extended it.  A new entry
        takes one allocator reference to its page, so the page survives the
        sequence's release; a page whose chain key is indexed already is
        skipped, and a host entry of the same content is pointed at the
        live page instead.  Returns the number of pages newly indexed.
        """
        bs = self.pool.block_size
        parent = b""
        added = 0
        for i in range(min(len(tokens) // bs, len(blocks))):
            key = _page_key(parent, tokens[i * bs:(i + 1) * bs])
            e = self.index.get(key)
            if e is None:
                self._tick += 1
                self.index[key] = _Entry(key, blocks[i], tick=self._tick)
                self.pool.allocator.share([blocks[i]])
                self.published_pages += 1
                added += 1
            elif e.block is None:
                # the same content is on the device again: point the entry
                # at the live page and drop the stale host copy
                e.block = blocks[i]
                e.host = None
                self.pool.allocator.share([blocks[i]])
                self._tick += 1
                e.tick = self._tick
            parent = key
        return added

    # -- host tier -------------------------------------------------------------

    def _evict(self, e: _Entry) -> None:
        """Move one cold page to the host and free its block."""
        pool = self.pool
        k, v = gather_tokens(pool, [e.block], pool.block_size)
        # a new host tensor, never a view of the pool: the block is
        # reallocated and overwritten at once.  The copy into pinned memory
        # is synchronous, so the bytes have landed before the release.
        host = torch.empty((2,) + tuple(k.shape), dtype=k.dtype,
                           pin_memory=pool.device.type == "cuda")
        host.copy_(torch.stack((k, v)))
        e.host = host
        self.evicted_bytes += host.nbytes
        pool.allocator.release([e.block])
        e.block = None
        if self.telemetry is not None and self.telemetry.enabled:
            self.telemetry.emit("evict", pages=1, bytes=host.nbytes)

    def _restore(self, e: _Entry) -> None:
        """Bring a host-tier page back into a fresh block."""
        alloc = self.pool.allocator
        if alloc.n_free < 1:
            self.reclaim(1, skip=e)
        if alloc.n_free < 1:
            raise MemoryError("no device block free to restore cached page")
        (b,) = alloc.alloc(1)
        # one host-to-device DMA (async from pinned memory; the scatter
        # after it is ordered on the same stream)
        kv = e.host.to(self.pool.device, non_blocking=True)
        scatter_tokens(self.pool, [b], kv[0], kv[1])
        nbytes = e.host.nbytes
        self.restored_bytes += nbytes
        e.block = b
        e.host = None
        if self.telemetry is not None and self.telemetry.enabled:
            self.telemetry.emit("restore", pages=1, bytes=nbytes)

    def cold_blocks(self) -> int:
        """Device pages held by the index alone (evictable on demand)."""
        refs = self.pool.allocator.refs
        return sum(1 for e in self.index.values()
                   if e.block is not None and refs[e.block] == 1)

    def reclaim(self, n: int, skip: _Entry | None = None) -> None:
        """Evict cold pages, least recently used first, until ``n`` blocks
        are free.  Only pages no sequence holds (count exactly 1, the
        index's own) are candidates."""
        alloc = self.pool.allocator
        if alloc.n_free >= n:
            return
        cold = [e for e in self.index.values()
                if e is not skip and e.block is not None
                and alloc.refs[e.block] == 1]
        cold.sort(key=lambda e: e.tick)
        for e in cold:
            if alloc.n_free >= n:
                break
            self._evict(e)

    def drop_cold(self) -> int:
        """Free every cold device page without a host copy (tests,
        teardown); returns the number of pages dropped."""
        alloc = self.pool.allocator
        dropped = 0
        for key in list(self.index):
            e = self.index[key]
            if e.block is not None and alloc.refs[e.block] == 1:
                alloc.release([e.block])
                del self.index[key]
                dropped += 1
                self.dropped_pages += 1
        return dropped

    # -- observability ---------------------------------------------------------

    def stats(self) -> dict:
        return {
            "entries": len(self.index),
            "device_pages": sum(1 for e in self.index.values()
                                if e.block is not None),
            "host_pages": sum(1 for e in self.index.values()
                              if e.host is not None),
            "cold_blocks": self.cold_blocks(),
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "evicted_bytes": self.evicted_bytes,
            "restored_bytes": self.restored_bytes,
        }
