"""KV migration: moving in-flight requests between engines (paper §4.2).

A deployment switch tears a replica down and resumes its in-flight
sequences on another.  ``migrate_batch`` restores each exported sequence by
the cheapest path the destination allows, in order:

  1. **Page handoff** (the same ``BlockPool``): the pages do not move.  The
     destination's view adopts them (allocator accounting and one
     block-table row), and decoding resumes with nothing recomputed.
  2. **Page copy / relayout** (another pool): the pages are copied into the
     destination's pool (``kvcache.copy_blocks``), or gathered densely and
     re-chunked when its page size differs (``kvcache.relayout_blocks``).
     Nothing is recomputed; both count as ``copied``/``pages_copied``.
  3. **Re-prefill** (no pages, or no room for them): the destination
     prefills ``prompt + generated`` again, chunked when its engine chunks;
     with a prefix cache it attaches the leading pages the index holds and
     prefills the rest.

Under greedy decoding all paths give the same tokens as an uninterrupted
run; they differ in the stall and the bytes moved.  The port's pools are
written in place, so a handoff must only re-register the pages (every view
of the pool already sees them), and a copy gathers into the destination's
own pages.  Call ``migrate_batch`` only between a ``finish_step`` and the
next ``step_async`` of either engine.  Moving pools between meshes
(``reshard_blocks`` in the JAX package) is not ported.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.engine import InflightSnapshot, ServingEngine


@dataclasses.dataclass
class MigrationReport:
    """What one migration batch did, by restore path."""
    handoff: int = 0            # same-pool ownership transfers (0 bytes)
    copied: int = 0             # cross-pool device page copies
    reprefilled: int = 0        # re-prefill fallback (tokens recomputed)
    requeued: int = 0           # never-admitted requests, plain re-submit
    pages_handoff: int = 0      # pages transferred by accounting only
    pages_copied: int = 0       # pages physically moved between pools
    recompute_tokens: int = 0   # context tokens the fallback re-prefills
    # failure recovery only: requests no survivor could hold, released and
    # shed by the cluster instead of wedging it (never set by a planned
    # switch, whose stranding pre-check runs before any engine is touched)
    dropped: int = 0
    # per-request restore path: rid -> (path, pages or recompute tokens),
    # path in {"handoff", "copy", "reprefill", "requeue"}
    paths: dict = dataclasses.field(default_factory=dict)

    @property
    def migrated(self) -> int:
        """In-flight (mid-generation) sequences moved, any path."""
        return self.handoff + self.copied + self.reprefilled

    def merge(self, other: "MigrationReport") -> None:
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if isinstance(a, dict):
                a.update(b)
            else:
                setattr(self, f.name, a + b)


def release_snapshot_pages(snap: InflightSnapshot) -> None:
    """Return a snapshot's held pages to their pool's allocator.

    Disowned pages belong to no view, so this is allocator bookkeeping
    only.  It drops the snapshot's reference to each page, and does not
    free it: a page the sequence attached from the prefix cache is also
    held by the cache's index, and perhaps by live sequences, and returns to
    the free list only when its last reference goes.  The call clears the
    snapshot's page fields, so a second call drops nothing twice.
    """
    if snap.blocks is not None and snap.pool is not None:
        snap.pool.allocator.release(snap.blocks)
    snap.blocks = None
    snap.pool = None
    snap.ssm = None
    snap.conv = None


def migrate_batch(dst: ServingEngine, snaps: list[InflightSnapshot]
                  ) -> MigrationReport:
    """Restore a batch of exported requests on ``dst``, cheapest path first.

    Snapshots with pages go through ``import_by_pages`` (handoff or copy);
    what the destination cannot hold by pages, and queued requests that
    never had pages, fall back to ``import_inflight`` (re-prefill).  Every
    held page ends owned by ``dst`` or released here.
    """
    report = MigrationReport()
    paged = [s for s in snaps if s.blocks is not None and s.generated]
    rest = [s for s in snaps if not (s.blocks is not None and s.generated)]
    # the path of each snapshot, taken before adoption clears its pages
    meta = {id(s): (s.pool is dst.cache.pool, len(s.blocks)) for s in paged}
    rejected = dst.import_by_pages(paged)
    rejected_ids = {id(s) for s in rejected}
    for s in paged:
        if id(s) in rejected_ids:
            continue
        same_pool, n = meta[id(s)]
        if same_pool:
            report.handoff += 1
            report.pages_handoff += n
            report.paths[s.rid] = ("handoff", n)
        else:
            report.copied += 1
            report.pages_copied += n
            report.paths[s.rid] = ("copy", n)
    fallback = rejected + rest
    for s in fallback:
        release_snapshot_pages(s)
        if s.generated:
            report.reprefilled += 1
            tokens = len(s.prompt) + len(s.generated)
            report.recompute_tokens += tokens
            report.paths[s.rid] = ("reprefill", tokens)
        else:
            report.requeued += 1
            report.paths[s.rid] = ("requeue", 0)
    if fallback:
        dst.import_inflight(fallback)
    return report
