"""The engine's compiled steps: one captured CUDA graph per step key.

The JAX engine never runs its hot path op by op: the one-shot prefill is
one jitted program per (group size, prompt length), the decode horizon
one per (batch bucket, page bucket, horizon) and the chunk forward one
per (chunk bucket, page bucket), the power-of-two buckets bounding how
many programs get compiled.  ``StepGraphs`` is PyTorch's
counterpart of those jit caches.  It maps a step key to an entry holding
static input buffers, the captured ``torch.cuda.CUDAGraph`` and its
static output.

- **First call of a key.**  The step runs eagerly on the entry's static
  buffers, on a side stream (``torch.cuda.graphs``' rule for warming up),
  and the call returns that run's result.  Then the step is captured on
  that same stream: a capture records the kernels without running them,
  so the pool's K/V tokens are written, and ``seq_lens_dev`` advanced,
  once.  The eager run also builds any kernel library and fills any lazy
  cache (cuBLAS handles and the stream's cuBLAS workspaces, the RoPE
  frequencies) before the capture: made inside it, a workspace would live
  in the graphs' memory pool for good, and the pool could never be given
  back.
- **Keys captured on reuse** (``ON_REUSE``: the one-shot prefill, keyed by
  a prompt length that traffic need not repeat).  The first call of such
  a key runs the step eagerly on the caller's inputs and builds nothing;
  the second builds the entry as above.  At most ``reuse_cap`` such
  entries are kept: building one more drops the least recently called
  (``evicted``), and a dropped key builds again on its next call.
- **Later calls.**  The new inputs are copied into the static buffers, the
  graph is replayed and its output copied out, so that no later replay
  (of this or another graph of the shared memory pool) overwrites it
  before the caller has read it.
- **Launch counts.**  The kernels count their own launches on the card
  (``build.LaunchCounter``): a replay counts each kernel it runs, the
  capture, which runs none, counts nothing, and nothing here touches a
  count.
- **Invalidation.**  A graph reads fixed addresses.  The caller passes
  every tensor its steps read (the K/V pools, the block table and lengths
  mirrors, the SSM rows, the parameters); when any address changes, every
  entry is dropped and each key captures again on its next call (an
  ``ON_REUSE`` key on its next two, as a new key).
- **On the CPU** the same code runs with "replay" meaning a call of the
  step the entry was built with on the same static buffers, and nothing
  is captured; a buffer left stale between two calls of a key gives wrong
  tokens there too, and so does a value the step baked in when it was
  built (a Python int in its closure), as a captured graph would replay
  it.

A failed capture or replay raises: there is no eager fallback.  All the
graphs of one ``StepGraphs`` share one memory pool
(``torch.cuda.graph_pool_handle()``), which ``release`` gives back.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import time

import torch

# the kinds of step whose keys are captured only when called again
ON_REUSE = ("prefill",)
# the most entries of those kinds one ``StepGraphs`` keeps: each holds its
# graph, input buffers and output ([B, Vpad] fp32 logits for a prefill)
REUSE_CAP = 64


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [] if tree is None else [tree]


@dataclasses.dataclass
class _Entry:
    static: dict                  # name -> input buffer
    # the step the entry was built with, on the CPU only: on the card the
    # graph replays, and a kept step (a bound method or closure of the
    # engine) would tie the engine to its graphs in a reference cycle
    step: object = None
    graph: torch.cuda.CUDAGraph | None = None
    out: torch.Tensor | None = None   # the graph's static output


class StepGraphs:
    """One engine's compiled steps (see the module docstring)."""

    def __init__(self, device, reuse_cap: int = REUSE_CAP):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self.reuse_cap = reuse_cap
        self.entries: dict[tuple, _Entry] = {}
        # the keys called since the last invalidation, entry or not: JAX's
        # jit cache holds one program for each
        self.called: dict[tuple, None] = {}
        # by kind of step: first calls of an ``ON_REUSE`` key, run eagerly;
        # entries built (on the card each is a capture); calls served by a
        # replay; entries dropped for ``reuse_cap``; and the seconds the
        # captures took (the building call's eager run not included)
        self.eager: collections.Counter = collections.Counter()
        self.built: collections.Counter = collections.Counter()
        self.replayed: collections.Counter = collections.Counter()
        self.evicted: collections.Counter = collections.Counter()
        self.capture_s = 0.0
        self._reads: tuple | None = None
        self._pool = None
        self._side = None

    @property
    def captures(self) -> int:
        return sum(self.built.values())

    @property
    def replays(self) -> int:
        return sum(self.replayed.values())

    def keys(self, kind: str) -> list[tuple]:
        """The keys of one kind of step ("prefill", "decode" or "chunk")
        called since the last invalidation."""
        return [k for k in self.called if k[0] == kind]

    def run(self, key: tuple, inputs: dict, step, reads) -> torch.Tensor:
        """``step(**buffers)`` for ``key`` on inputs copied into its static
        buffers; returns the step's output tensor.  ``reads``: every tensor
        the step reads besides its inputs.  ``step`` is called (and, on the
        card, captured) only when the key's entry is built, or on the first
        call of an ``ON_REUSE`` key: later calls replay the entry's step,
        whatever step they pass."""
        fp = tuple(t.data_ptr() for t in reads)
        if fp != self._reads:
            # a graph would read freed or moved memory: capture anew, in
            # a fresh pool
            self.release()
            self._reads = fp
            self._pool = (torch.cuda.graph_pool_handle() if self.capture
                          else None)
        kind = key[0]
        entry = self.entries.get(key)
        if entry is not None:
            if kind in ON_REUSE:
                self.entries[key] = self.entries.pop(key)   # most recent
            return self._replay(key, entry, inputs)
        if kind in ON_REUSE and key not in self.called:
            self.called[key] = None
            self.eager[kind] += 1
            return step(**inputs)
        self.called[key] = None
        out = self._build(key, inputs, step)
        if kind in ON_REUSE:
            held = [k for k in self.entries if k[0] in ON_REUSE]
            for k in held[:max(0, len(held) - self.reuse_cap)]:
                del self.entries[k]
                self.evicted[k[0]] += 1
        return out

    def release(self) -> None:
        """Drop every entry, and with them the graphs' memory pool (the
        allocator's cache keeps the freed blocks until ``empty_cache``)."""
        self.entries.clear()
        self.called.clear()
        self._pool = None
        self._reads = None

    def _build(self, key, inputs, step) -> torch.Tensor:
        static = {n: t.contiguous().clone() for n, t in inputs.items()}
        if not self.capture:
            out = step(**static)
            self.entries[key] = _Entry(static, step)
            self.built[key[0]] += 1
            return out
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            out = step(**static)        # the call's result, run off-capture
        cur.wait_stream(self._side)
        # the capture begins with a device sync: wait for the eager run
        # first, so that capture_s times the capture alone
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection during the capture: a graph that dies in a
        # collected reference cycle is destroyed there, which a capture
        # does not permit (it fails with the capture invalidated)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._side):
                static_out = step(**static)
        finally:
            if collecting:
                gc.enable()
        self.capture_s += time.perf_counter() - t0
        self.built[key[0]] += 1
        self.entries[key] = _Entry(static, graph=graph, out=static_out)
        return out

    def _replay(self, key, entry: _Entry, inputs: dict) -> torch.Tensor:
        for name, t in inputs.items():
            entry.static[name].copy_(t)
        self.replayed[key[0]] += 1
        if entry.graph is None:
            return entry.step(**entry.static)
        entry.graph.replay()
        return entry.out.clone()
