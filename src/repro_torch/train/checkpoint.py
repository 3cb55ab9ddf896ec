"""Checkpointing with async save, manifests, and crash-safe restore (the JAX
package's ``train/checkpoint.py``, same on-disk layout).

Layout:
  <dir>/step_000000123/
      manifest.json        # leaf paths, shapes, dtypes
      leaf_00000.npy ...   # one file per leaf
      COMMITTED            # written last; restores ignore uncommitted dirs

A step is written into ``step_<n>.tmp`` and renamed into place; the newest
``keep`` steps are kept.  Leaf paths are the strings JAX's
``tree_flatten_with_path`` gives a nested dict (``['opt']/['m']/...``, in
sorted key order), so a checkpoint the JAX trainer wrote restores into the
port's train state and the other way round.

``save`` copies every leaf to host numpy before it returns (the port's
optimizer updates its tensors in place, so the async writer would
otherwise race the next step); the writes run on a worker thread.  A
bf16 leaf is written as the JAX package writes one (numpy has no
bfloat16): 2-byte raw records (``|V2``) under the manifest dtype
"bfloat16"; ``restore`` reads each leaf by its manifest dtype, a bf16 one
by viewing the records as int16 and then as ``torch.bfloat16``, so no
bit is lost to a float round trip.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

from repro_torch.train.optimizer import tree_map


def flatten_with_paths(tree, prefix: str = ""):
    """[(path, leaf)] in sorted key order, paths as JAX spells them."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            key = f"['{k}']"
            out += flatten_with_paths(tree[k],
                                      f"{prefix}/{key}" if prefix else key)
        return out
    return [(prefix, tree)]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of one leaf and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A leaf read from disk, by its manifest dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    # -- save ---------------------------------------------------------------

    def save(self, state, step: int, blocking: bool = False,
             layout=None) -> None:
        """Save ``state``; a sharded train state with its ``layout`` (cfg,
        plan, mesh) is gathered into the logical arrays first, so the
        checkpoint is the JAX package's layout whatever the plan."""
        if layout is not None:
            from repro_torch.launch.sharding import gather_train_state
            state = gather_train_state(state, *layout)
        flat = flatten_with_paths(state)
        paths = [p for p, _ in flat]
        host_leaves = [_to_host(leaf) for _, leaf in flat]
        if blocking:
            self._write(paths, host_leaves, step)
        else:
            self._q.put((paths, host_leaves, step))

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            self._write(*item)
            self._q.task_done()

    def _write(self, paths, leaves, step: int) -> None:
        out = os.path.join(self.dir, f"step_{step:09d}")
        tmp = out + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, (path, (leaf, dtype)) in enumerate(zip(paths, leaves)):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), leaf)
            manifest["leaves"].append(
                {"path": path, "file": fname,
                 "shape": list(leaf.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        shutil.rmtree(out, ignore_errors=True)
        os.replace(tmp, out)
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        self._q.join()

    # -- restore -------------------------------------------------------------

    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "COMMITTED"))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, template, step: int, layout=None):
        """Restore into the structure of ``template`` (shapes must match):
        each leaf on the template leaf's device, in its dtype.  With a
        ``layout`` (cfg, plan, mesh) the template is a sharded train state
        and so is the result: the logical arrays are cut by that plan,
        whichever plan (or none) saved them."""
        if layout is not None:
            from repro_torch.launch.sharding import (gather_train_state,
                                                     shard_train_state)
            logical = self.restore(gather_train_state(template, *layout),
                                   step)
            return shard_train_state(logical, *layout)
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        new_leaves = []
        for path, leaf in flatten_with_paths(template):
            entry = by_path[path]
            arr = np.load(os.path.join(d, entry["file"]))
            assert list(arr.shape) == list(leaf.shape), \
                f"shape mismatch at {path}: {arr.shape} vs {leaf.shape}"
            new_leaves.append(_from_host(arr, entry["dtype"]).to(
                device=leaf.device, dtype=leaf.dtype))
        it = iter(new_leaves)
        return tree_map(lambda _: next(it), template)

    def restore_latest(self, template, layout=None):
        steps = self.list_steps()
        if not steps:
            return None
        step = steps[-1]
        return self.restore(template, step, layout), step
