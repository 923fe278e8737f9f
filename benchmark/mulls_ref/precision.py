"""The precision the reference computes its products in.

``fp32`` (the default) is the precision the configuration states: float32
with TF32 off.  ``tf32`` is the benchmark's control, the step that would
tempt a later change: every operand of a product (the neighbourhood
operations' points and features, ``core/batch.py``'s small matrix
products, rotations and matrix-vector products) is rounded to TF32 (a
10-bit mantissa, to nearest) and the products are summed in float32, as
tensor cores do with TF32 operands.
"""

from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32")
_precision = "fp32"


def set_precision(name: str) -> None:
    global _precision
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r}: one of {PRECISIONS}")
    _precision = name


def precision() -> str:
    return _precision


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties to
    even), held in float32."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def product_operand(t: torch.Tensor) -> torch.Tensor:
    """An operand of ``core/batch.py``'s products: rounded to TF32 under
    ``tf32``, as it is."""
    if _precision == "tf32" and t.dtype == torch.float32:
        return to_tf32(t)
    return t
