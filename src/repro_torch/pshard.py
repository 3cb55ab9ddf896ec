"""Logical-axis sharding annotations, decoupled from the model code: the
port's copy of the JAX package's ``pshard.py``.

``sharding_rules(mesh, rules)`` installs a mapping (logical axis name ->
mesh axis / None) plus the mesh for the enclosed code; ``spec_for(*axes)``
resolves logical axes to a ``P`` under the installed rules (``P()``
outside any).  ``P`` is a plain tuple standing in for JAX's
``PartitionSpec``: entry i names the mesh axis (or tuple of axes, or
None) that axis i of an array is split over.

``logical(x, *axes)`` only checks that ``x`` has one logical axis per
dimension and returns it unchanged.  In JAX it becomes a
``with_sharding_constraint`` that GSPMD propagates; the port has no
partitioner.  Its sharded replicas are run by an explicit executor
(``repro_torch.models.sharded``) that holds every shard's slice on its own
device and reduces at fixed points, so nothing binds here.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


class P(tuple):
    """A partition spec: ``P("model", None)`` splits axis 0 over ``model``
    and keeps axis 1 whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def current_rules():
    """(mesh, rules) of the innermost ``sharding_rules``, or None."""
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def sharding_rules(mesh, rules: dict):
    """Install logical->mesh axis rules for the enclosed code."""
    prev = getattr(_state, "rules", None)
    _state.rules = (mesh, rules)
    try:
        yield
    finally:
        _state.rules = prev


def spec_for(*axes: str | None) -> P:
    ctx = current_rules()
    if ctx is None:
        return P()
    _, rules = ctx
    return P(*(None if a is None else rules.get(a) for a in axes))


def logical(x, *axes: str | None):
    """Check that ``x`` (rank == len(axes)) names one logical axis per
    dimension; return it unchanged (see the module docstring)."""
    if len(axes) != x.ndim:
        raise ValueError(f"logical axes {axes} for a rank-{x.ndim} array")
    return x
