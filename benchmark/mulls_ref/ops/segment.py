"""Segment sums whose order of addition is fixed by the input.

``index_add_`` / ``index_put_(accumulate=True)`` on CUDA add floats with
atomics, in the order the scheduler happens to run them, so two runs of
the same input can differ in their last bits (and a frame's ground filter,
a PGO solve or a voxel table with them).  :func:`segment_sum` sorts the
rows by segment with a stable sort, then adds each segment's rows in that
order (``torch.segment_reduce``: no atomics), so every run on a device
gives the same bits.  On the CPU the result equals ``index_add_``'s bit
for bit (both add each segment's rows in index order).

With leading batch dimensions, each batch entry's ids are offset into one
range (``s * num_segments + seg``), so one sort and one ``segment_reduce``
serve all entries and each segment adds its rows in the order it would
alone: the same bits as the entry's call without a batch.
"""

from __future__ import annotations

import torch

from mulls_ref.core.batch import offsets


def segment_sum(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """[..., n, ...] rows summed into ``num_segments`` rows by ``seg``
    [..., n] (ids in [0, num_segments)); an empty segment sums to 0."""
    lead = tuple(seg.shape[:-1])
    if lead:
        flat = (seg.to(torch.int64)
                + offsets(lead, num_segments, seg.device)).reshape(-1)
        rest = data.shape[len(lead) + 1:]
        n_entries = 1
        for d in lead:
            n_entries *= d
        out = segment_sum(data.reshape(-1, *rest), flat,
                          n_entries * num_segments)
        return out.reshape(*lead, num_segments, *rest)
    seg = seg.to(torch.int64)
    sorted_seg, order = torch.sort(seg, stable=True)
    # segment lengths from the sorted ids: no host sync (bincount has one)
    bounds = torch.searchsorted(sorted_seg, torch.arange(
        num_segments + 1, dtype=torch.int64, device=seg.device))
    return torch.segment_reduce(data[order], "sum", lengths=bounds.diff(),
                                axis=0, unsafe=True)
