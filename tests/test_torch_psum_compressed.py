"""The port's ``psum_compressed`` (``torch.distributed``, a 2-rank gloo
world on the CPU joined through a ``FileStore``) against the JAX
package's under ``shard_map`` on 2 host devices (a subprocess, since only
a fresh process gets them): the same per-rank gradients give the same
average, to the bit, on both ranks."""
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.train.optimizer import compress_roundtrip, psum_compressed

WORLD = 2
# leaves of odd sizes: a padded last block, a leaf under one block
SHAPES = {"a": (3, 300), "b": (17,), "c": (2, 2, 129)}

JAX_SCRIPT = r"""
import sys
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
from repro.train.optimizer import psum_compressed

assert len(jax.devices()) == 2
data = dict(np.load(sys.argv[1]))
grads = {k: jax.numpy.asarray(v) for k, v in data.items()}
mesh = jax.sharding.Mesh(np.array(jax.devices()), ("x",))

def body(g):
    g = jax.tree.map(lambda a: a[0], g)
    out = psum_compressed(g, "x")
    return jax.tree.map(lambda a: a[None], out)

out = shard_map(body, mesh=mesh, in_specs=P("x"), out_specs=P("x"))(grads)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _grads():
    rng = np.random.RandomState(11)
    # per-rank gradients stacked on axis 0, with a spread of magnitudes so
    # the two ranks' scales differ block by block
    return {k: (rng.standard_normal((WORLD,) + s)
                * np.exp(rng.uniform(-3, 3, (WORLD,) + s))).astype(np.float32)
            for k, s in SHAPES.items()}


def _rank(rank, store_path, grads_path, out_path):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        data = np.load(grads_path)
        g = {k: torch.from_numpy(data[k][rank].copy()) for k in SHAPES}
        out = psum_compressed(g)
        np.savez(out_path.replace(".npz", f"-{rank}.npz"),
                 **{k: v.numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def test_psum_compressed_equals_jax_to_the_bit(tmp_path):
    grads = _grads()
    grads_path = str(tmp_path / "grads.npz")
    np.savez(grads_path, **grads)
    jax_out = str(tmp_path / "jax.npz")
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, grads_path,
                        jax_out], env=env, capture_output=True, text=True,
                       timeout=300,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(jax_out)

    out = str(tmp_path / "torch.npz")
    mp.spawn(_rank, args=(str(tmp_path / "store"), grads_path, out),
             nprocs=WORLD, join=True)
    for rank in range(WORLD):
        got = np.load(out.replace(".npz", f"-{rank}.npz"))
        for k in SHAPES:
            assert got[k].shape == SHAPES[k]
            np.testing.assert_array_equal(
                got[k].view(np.uint32), want[k][rank].view(np.uint32),
                err_msg=f"rank {rank} leaf {k}")
    # the two ranks' average differs from either rank's own roundtrip
    own = compress_roundtrip({k: torch.from_numpy(v[0])
                              for k, v in grads.items()})
    assert not np.array_equal(own["a"].numpy(), want["a"][0])
