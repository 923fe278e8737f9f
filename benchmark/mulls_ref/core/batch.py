"""Helpers for functions written over leading batch dimensions.

The front end's functions take clouds of shape ``[..., N, ...]``: no
leading dimension for one sequence, ``[S]`` for the S sequences of
``parallel/multiseq.py`` stepped as one.  A sequence of a batched call
must get the bits of its call alone, on the CPU and on the card, so the
arithmetic here avoids every operation whose order of addition depends on
the batch (measured on an H100 and on the CPU, ``PERF.md`` §6):

* :func:`fsum` — a sum whose order depends only on the length summed: a
  fixed tree of inner reductions of at most 32 terms.  ``torch.sum`` over a
  long axis picks its block split from the number of outputs on the card,
  so ``[S, N]`` and ``[N]`` add in different orders.
* :func:`matmul` / :func:`matvec` / :func:`rotate` — small matrix
  products as an elementwise product and an inner sum, in place of cuBLAS
  / MKL, whose batched kernels differ from their single ones (on the CPU
  even ``points @ R^T`` does at some sizes).
* :func:`take` / :func:`put` — row gathers and scatters along the point
  axis of each batch entry.
* :func:`where` — ``torch.where`` with a per-entry condition.
"""

from __future__ import annotations

import torch

from mulls_ref.precision import product_operand

_TREE = 32  # terms of one inner reduction of :func:`fsum`


def fsum(x: torch.Tensor, dim: int = -1, keepdim: bool = False
         ) -> torch.Tensor:
    """Sum over ``dim`` in an order fixed by its length alone: rounds of
    inner sums of ``_TREE`` terms (zero padded), so every batch entry adds
    its terms as it would alone."""
    dim = dim % x.dim()
    y = x.movedim(dim, -1)
    if not y.is_contiguous():
        y = y.contiguous()
    while y.shape[-1] > _TREE:
        pad = (-y.shape[-1]) % _TREE
        if pad:
            y = torch.nn.functional.pad(y, (0, pad))
        y = y.reshape(*y.shape[:-1], -1, _TREE).sum(-1)
    y = y.sum(-1)
    return y.unsqueeze(dim) if keepdim else y


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for small ``[..., m, k] x [..., k, n]`` matrices: products
    summed along k, the same in a batch as alone."""
    a, b = product_operand(a), product_operand(b)
    bt = b.transpose(-1, -2).contiguous()
    return (a[..., :, None, :] * bt[..., None, :, :]).sum(-1)


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` for ``[..., m, k] x [..., k]`` (``a`` may carry more
    leading dimensions than ``x``, as rows of points do)."""
    a, x = product_operand(a), product_operand(x)
    return (a.contiguous() * x.unsqueeze(-2)).sum(-1)


def rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R`` [..., 3, 3] applied to the rows of ``v`` [..., N, 3]."""
    R, v = product_operand(R), product_operand(v)
    prod = v[..., :, None, :] * R[..., None, :, :]
    return prod.contiguous().sum(-1)


def expand_like(c, x: torch.Tensor) -> torch.Tensor:
    """A per-entry ``c`` (a number or a tensor of ``x``'s leading shape)
    with singleton dimensions appended to broadcast against ``x``."""
    if not torch.is_tensor(c) or c.dim() == 0:
        return c
    return c.reshape(c.shape + (1,) * (x.dim() - c.dim()))


def where(cond, a: torch.Tensor, b) -> torch.Tensor:
    """``torch.where`` with a condition over the batch dimensions only."""
    return torch.where(expand_like(cond, a), a, b)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [..., K] of ``x`` [..., N, *rest] along the point axis
    of each batch entry: [..., K, *rest] (``x[idx]`` without a batch)."""
    axis = idx.dim() - 1
    rest = x.shape[axis + 1:]
    if not rest:
        return torch.gather(x, axis, idx.to(torch.int64))
    index = idx.to(torch.int64).reshape(idx.shape + (1,) * len(rest))
    return torch.gather(x, axis, index.expand(*idx.shape, *rest))


def put(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with rows ``idx`` [..., K] set to ``v`` [..., K,
    *rest] (``x[idx] = v``: a row named twice takes its last value on the
    CPU and any one of its values on the card, as with ``index_put_``)."""
    axis = idx.dim() - 1
    rest = x.shape[axis + 1:]
    index = idx.to(torch.int64).reshape(idx.shape + (1,) * len(rest))
    return x.scatter(axis, index.expand(*idx.shape, *rest), v)


def offsets(shape: tuple, n: int, device) -> torch.Tensor:
    """``n`` times each batch entry's flat number, shaped ``shape + (1,)``
    (segment ids of separate entries offset into one range)."""
    k = 1
    for s in shape:
        k *= s
    return (torch.arange(k, dtype=torch.int64, device=device) * n).reshape(
        *shape, 1)
