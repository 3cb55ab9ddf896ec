"""The engine's compiled steps: one captured CUDA graph per step key.

The JAX engine never runs its hot path op by op: the decode horizon is one
jitted program per (batch bucket, page bucket, horizon) and the chunk
forward one per (chunk bucket, page bucket), the power-of-two buckets
bounding how many programs get compiled.  ``StepGraphs`` is PyTorch's
counterpart of those jit caches.  It maps a step key to an entry holding
static input buffers, the captured ``torch.cuda.CUDAGraph`` and its
static output.

- **First call of a key.**  The step runs eagerly on the entry's static
  buffers, off the capture stream (``torch.cuda.graphs``' rule for warming
  up), and the call returns that run's result.  Then the step is captured:
  a capture records the kernels without running them, so the pool's K/V
  tokens are written, and ``seq_lens_dev`` advanced, once.  The eager run
  also builds any kernel library and fills any lazy cache (cuBLAS handles,
  the RoPE frequencies) before the capture.
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
  entry is dropped and each key captures again on its next call.
- **On the CPU** the same code runs with "replay" meaning a call of the
  same step on the same static buffers, and nothing is captured; a buffer
  left stale between two calls of a key gives wrong tokens there too.

A failed capture or replay raises: there is no eager fallback.  All the
graphs of one ``StepGraphs`` share one memory pool
(``torch.cuda.graph_pool_handle()``), which ``release`` gives back.
"""
from __future__ import annotations

import dataclasses
import time

import torch


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [] if tree is None else [tree]


@dataclasses.dataclass
class _Entry:
    static: dict                  # name -> input buffer
    graph: torch.cuda.CUDAGraph | None = None
    out: torch.Tensor | None = None   # the graph's static output


class StepGraphs:
    """One engine's compiled steps (see the module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self.entries: dict[tuple, _Entry] = {}
        # entries built (first calls of a key, or after an invalidation;
        # on the card each is a capture), calls served by a replay, and
        # the seconds the captures took (the first call's eager run not
        # included)
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self._reads: tuple | None = None
        self._pool = None
        self._side = None

    def keys(self, kind: str) -> list[tuple]:
        """The keys of one kind of step ("decode" or "chunk")."""
        return [k for k in self.entries if k[0] == kind]

    def run(self, key: tuple, inputs: dict, step, reads) -> torch.Tensor:
        """``step(**buffers)`` for ``key`` on inputs copied into its static
        buffers; returns the step's output tensor.  ``reads``: every tensor
        the step reads besides its inputs."""
        fp = tuple(t.data_ptr() for t in reads)
        if fp != self._reads:
            # a graph would read freed or moved memory: capture anew, in
            # a fresh pool
            self.release()
            self._reads = fp
            self._pool = (torch.cuda.graph_pool_handle() if self.capture
                          else None)
        entry = self.entries.get(key)
        if entry is None:
            return self._build(key, inputs, step)
        return self._replay(entry, inputs, step)

    def release(self) -> None:
        """Drop every entry, and with them the graphs' memory pool (the
        allocator's cache keeps the freed blocks until ``empty_cache``)."""
        self.entries.clear()
        self._pool = None
        self._reads = None

    def _build(self, key, inputs, step) -> torch.Tensor:
        static = {n: t.contiguous().clone() for n, t in inputs.items()}
        if not self.capture:
            out = step(**static)
            self.entries[key] = _Entry(static)
            self.captures += 1
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
        with torch.cuda.graph(graph, pool=self._pool):
            static_out = step(**static)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        self.entries[key] = _Entry(static, graph, static_out)
        return out

    def _replay(self, entry: _Entry, inputs: dict, step) -> torch.Tensor:
        for name, t in inputs.items():
            entry.static[name].copy_(t)
        self.replays += 1
        if entry.graph is None:
            return step(**entry.static)
        entry.graph.replay()
        return entry.out.clone()
