"""Map the JAX package's parameter pytree onto the port's parameters.

The JAX ``init_params`` pytree (``embed``, layer-stacked ``blocks.*``,
``final_norm``, ``lm_head`` unless tied), given as numpy arrays, has the
same keys, shapes and ``x @ w`` orientation as the port's parameters, so the
conversion is a checked copy.  Tests use it to feed identical weights to
both packages.  The SSM leaves the JAX package keeps in fp32
(``ssm.FP32_KEYS``: ``dt_bias``, ``A_log``, ``D``) stay fp32 whatever
``dtype`` is asked for.  ``lstm_params_from_jax`` does the same for the
workload predictor's LSTM (``core.predictor``), whose JAX parameters have
the port's keys, shapes and orientation too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import FP32_KEYS


_FP32_PATHS = frozenset(f"params.blocks.ssm.{k}" for k in FP32_KEYS)


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
    if path in _FP32_PATHS:
        dtype = torch.float32
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _check_shape(np_tree, path: str, want: tuple, cfg: ModelConfig) -> None:
    node = np_tree
    for key in path.split("."):
        if key not in node:
            raise ValueError(f"params has no {path} for {cfg.name}")
        node = node[key]
    if np.shape(node) != want:
        raise ValueError(f"{path} shape {np.shape(node)} does not match "
                         f"{cfg.name}")


def from_jax_params(np_tree: dict, cfg: ModelConfig, device="cuda",
                    dtype=torch.float32) -> dict:
    """Numpy copy of a JAX params pytree -> the port's params on ``device``.

    Checks the top-level keys and the embedding / stacked-layer shapes
    (attention and SSM, as ``cfg`` has them) against ``cfg``.
    """
    top = set(np_tree)
    if top != _expected_top(cfg):
        raise ValueError(f"params keys {sorted(top)} do not match "
                         f"{sorted(_expected_top(cfg))} for {cfg.name}")
    L, d = cfg.n_layers, cfg.d_model
    _check_shape(np_tree, "embed", (cfg.padded_vocab(), d), cfg)
    if cfg.has_attn:
        _check_shape(np_tree, "blocks.attn.wq", (L, d, cfg.q_dim), cfg)
    if cfg.has_ssm:
        _check_shape(np_tree, "blocks.ssm.w_x", (L, d, cfg.d_inner), cfg)
    return _to_torch(np_tree, device, dtype, "params")


def lstm_params_from_jax(np_params: dict, device="cuda") -> dict:
    """The JAX predictor's LSTM parameters (``lstm_init``'s dict, as numpy
    arrays) -> the port's, fp32 on ``device``; checks keys and shapes."""
    from repro_torch.core.predictor import LSTM_KEYS
    if set(np_params) != set(LSTM_KEYS):
        raise ValueError(f"LSTM params keys {sorted(np_params)} are not "
                         f"{sorted(LSTM_KEYS)}")
    in_dim = np.shape(np_params["wx"])[0]
    hidden, out_dim = np.shape(np_params["w_out"])
    want = {"wx": (in_dim, 4 * hidden), "wh": (hidden, 4 * hidden),
            "b": (4 * hidden,), "w_out": (hidden, out_dim),
            "b_out": (out_dim,)}
    for k, shape in want.items():
        if np.shape(np_params[k]) != shape:
            raise ValueError(f"LSTM {k} shape {np.shape(np_params[k])} is "
                             f"not {shape}")
    return {k: torch.from_numpy(np.array(np_params[k], dtype=np.float32))
            .to(device) for k in LSTM_KEYS}
