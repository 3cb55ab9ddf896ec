"""Map the JAX package's parameter pytree onto the port's parameters.

The JAX ``init_params`` pytree (``embed``, layer-stacked ``blocks.*``,
``final_norm``, ``lm_head`` unless tied), given as numpy arrays, has the
same keys, shapes and ``x @ w`` orientation as the port's parameters, so the
conversion is a checked copy.  Tests use it to feed identical weights to
both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def _expected_top(cfg: ModelConfig) -> set[str]:
    keys = {"embed", "blocks", "final_norm"}
    if not cfg.tie_embeddings:
        keys.add("lm_head")
    return keys


def _to_torch(tree, device, dtype, path: str):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype, f"{path}.{k}")
                for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind in "biu":     # bf16 arrays (ml_dtypes) are kind "V"
        raise TypeError(f"{path}: expected a float array, got {arr.dtype}")
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=device, dtype=dtype)


def from_jax_params(np_tree: dict, cfg: ModelConfig, device="cuda",
                    dtype=torch.float32) -> dict:
    """Numpy copy of a JAX params pytree -> the port's params on ``device``.

    Checks the top-level keys and the embedding / stacked-layer shapes
    against ``cfg``.
    """
    top = set(np_tree)
    if top != _expected_top(cfg):
        raise ValueError(f"params keys {sorted(top)} do not match "
                         f"{sorted(_expected_top(cfg))} for {cfg.name}")
    emb = np.shape(np_tree["embed"])
    if emb != (cfg.padded_vocab(), cfg.d_model):
        raise ValueError(f"embed shape {emb} does not match {cfg.name}")
    wq = np.shape(np_tree["blocks"]["attn"]["wq"])
    if wq != (cfg.n_layers, cfg.d_model, cfg.q_dim):
        raise ValueError(f"blocks.attn.wq shape {wq} does not match "
                         f"{cfg.name}")
    return _to_torch(np_tree, device, dtype, "params")
