"""Dataclasses of tensors and a ``tree_map`` over them — the port's
counterpart of ``flax.struct`` dataclasses and ``jax.tree.map``."""

from __future__ import annotations

import dataclasses

import torch


class Struct:
    """Mixin for ``@dataclass``es of tensors: ``replace`` returns a copy
    with some fields swapped (``flax.struct`` parity)."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to matching leaves of dataclasses / dicts / tuples.
    ``None`` stays ``None``; any other object is a leaf."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_where(cond: torch.Tensor, a, b):
    """Leafwise ``torch.where(cond, a, b)`` for a bool ``cond`` over the
    leaves' leading (batch) dimensions: 0-d for one sequence."""
    def pick(x, y):
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))
        return torch.where(c, x, y)
    return tree_map(pick, a, b)
