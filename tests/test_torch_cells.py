"""The cell-grid index of ``count_within`` (mulls_tpu_torch/ops/kernels.py::
cell_index), on the CPU.

The CUDA kernel (csrc/count_within.cu) walks, for each query, the 9 key
ranges that :func:`kernels.neighbour_ranges` returns, and counts the points
within r2 there.  The kernel runs only on a card (tests/test_torch_cuda.py
holds it to ``count_within_plain`` there).  Here a walk written in this
file over the same index stands in for it, and must give the plain
version's counts exactly, on the inputs where a grid can go wrong: points
on cell borders and exactly r apart, negative coordinates, per-query radii
of 0 and below, masked and empty support, queries far outside the box, all
points in one cell, a 1 km extent at r = 0.05, and NaN or infinite radii
and coordinates."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mulls_tpu_torch.ops import kernels



@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _walk(q, p, pm, r2):
    """float32 [Q]: the kernel's walk in tensor ops: for each query the
    points of its 9 ranges, the distance formed as the kernel forms it
    (((dx dx + dy dy) + dz dz), each op rounded), compared with r2."""
    index = kernels.cell_index(p, pm, r2)
    order, cells = kernels.query_cells(q, index)
    start, end = kernels.neighbour_ranges(cells, index)
    counts = torch.zeros(q.shape[0], dtype=torch.float32)
    width = int((end - start).max()) if q.shape[0] else 0
    if width == 0:
        return counts
    j = start[:, :, None] + torch.arange(width)
    inside = j < end[:, :, None]
    pts = index.points[j.clamp(max=index.points.shape[0] - 1), :3]
    d = q[order][:, None, None, :] - pts
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    hit = inside & (d2 <= r2[order][:, None, None])
    counts[order] = hit.sum((1, 2)).to(torch.float32)
    return counts


def _check(q, p, pm, r2):
    q, p, r2 = (torch.as_tensor(np.asarray(a, np.float32)) for a in (q, p, r2))
    pm = torch.as_tensor(np.asarray(pm, bool))
    want = kernels.count_within_plain(q, p, pm, r2)
    got = _walk(q, p, pm, r2)
    assert torch.equal(got, want), (got - want).abs().max()
    # the CPU wrapper is the plain version
    assert torch.equal(kernels.count_within(q, p, pm, r2), want)
    return want


_coord = st.floats(-50.0, 50.0, allow_nan=False, width=32)


@settings(max_examples=40, deadline=None)
@given(step=st.sampled_from([0.05, 0.25, 0.5, 1.0]),
       origin=st.tuples(_coord, _coord, _coord),
       seed=st.integers(0, 2 ** 31 - 1))
def test_points_on_cell_borders_and_exactly_r_apart(step, origin, seed):
    """Support on a lattice of pitch r (so r apart along each axis, and on
    the borders of cells of side ~r), queries on it and offset by r, r2 =
    r^2 exactly as float32."""
    rng = np.random.default_rng(seed)
    ijk = rng.integers(-6, 7, (300, 3))
    p = (np.asarray(origin) + ijk * step).astype(np.float32)
    shift = np.eye(3)[rng.integers(0, 3, 120)] * rng.choice([-1, 1], (120, 1))
    q = np.concatenate([p[:60], p[60:180] + shift * step]).astype(np.float32)
    r2 = np.full(len(q), np.float32(step) * np.float32(step), np.float32)
    counts = _check(q, p, np.ones(len(p), bool), r2)
    assert float(counts.max()) >= 2  # some lattice neighbours at exactly r


@pytest.mark.parametrize("r", [0.5, 0.07])
def test_pairs_just_inside_r_at_every_offset_in_a_cell(r):
    """4,000 pairs 0.9999 r apart along an axis, at uniform offsets of the
    query within its cell: a cell side even 0.1 % below r would put some of
    them two cells apart, and the walk would miss them."""
    rng = np.random.default_rng(13)
    n = 4000
    q = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    axis = np.eye(3)[rng.integers(0, 3, n)] * rng.choice([-1, 1], (n, 1))
    p = np.concatenate([q + axis * (0.9999 * r), q + axis * (0.5 * r)])
    counts = _check(q, p, np.ones(2 * n, bool), np.full(n, r * r))
    assert float(counts.min()) >= 2  # the point just inside r, the one r / 2


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       extent=st.sampled_from([0.5, 5.0, 60.0]),
       valid=st.sampled_from([0.0, 0.3, 0.9, 1.0]),
       n_p=st.integers(0, 400), n_q=st.integers(1, 150))
def test_masked_empty_negative_and_far_queries(seed, extent, valid, n_p,
                                                n_q):
    """Negative coordinates around the origin, masked support (none valid
    included), per-query r2 with 0 and negative values, and a third of the
    queries far outside the support's box."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-extent, extent, (n_p, 3))
    pm = rng.uniform(size=n_p) < valid
    q = rng.uniform(-extent, extent, (n_q, 3))
    far = rng.uniform(size=n_q) < 0.33
    q[far] += rng.choice([-1, 1], (int(far.sum()), 3)) * rng.uniform(
        2, 40, (int(far.sum()), 3)) * extent
    r = extent / 4
    r2 = rng.choice([-1.0, 0.0, 0.25 * r * r, r * r, 4 * r * r], n_q)
    # a few queries on support points with r2 = 0: they count themselves
    k = min(n_q, n_p, 5)
    q[:k] = p[:k]
    _check(q, p, pm, r2)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_all_points_in_one_cell(seed):
    """A radius larger than the box: one cell holds every point, and every
    query walks it."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.3, 0.3, (500, 3))
    q = rng.uniform(-0.6, 0.6, (200, 3))
    r2 = rng.uniform(0.01, 4.0, 200)
    index = kernels.cell_index(torch.as_tensor(p, dtype=torch.float32),
                               torch.ones(500, dtype=torch.bool),
                               torch.as_tensor(r2, dtype=torch.float32))
    assert index.dims == (1, 1, 1) and bool((index.keys == 0).all())
    _check(q, p, np.ones(500, bool), r2)


def test_a_kilometre_at_five_centimetres():
    """1 km of support at r = 0.05: a grid of 20,000 x 20,000 x 2 cells,
    held in O(P) memory, and exact counts."""
    rng = np.random.default_rng(7)
    n = 20000
    # dense patches spread over a 1 km square, so neighbourhoods are not
    # empty
    centres = rng.uniform(-500, 500, (200, 2))
    xy = centres[rng.integers(0, 200, n)] + rng.normal(0, 0.1, (n, 2))
    p = np.concatenate([xy, rng.uniform(-0.05, 0.05, (n, 1))], 1)
    q = p[:3000] + rng.normal(0, 0.02, (3000, 3))
    r2 = np.full(3000, 0.05 ** 2)
    counts = _check(q, p, np.ones(n, bool), r2)
    assert float(counts.mean()) > 1.0
    index = kernels.cell_index(torch.as_tensor(p, dtype=torch.float32),
                               torch.ones(n, dtype=torch.bool),
                               torch.as_tensor(r2, dtype=torch.float32))
    assert index.dims[0] * index.dims[1] > 1e8  # far more cells than points


NON_FINITE_KINDS = ["nan_radius", "all_radii_nan", "inf_radius",
                    "nan_support", "inf_support", "inf_support_inf_radius",
                    "non_finite_queries", "no_finite_support"]


def non_finite_case(kind, rng):
    """NaN and infinite radii and coordinates, as numpy.  A NaN radius or
    coordinate counts nothing in the plain version; an infinite radius
    counts every valid point at a finite distance, infinite ones too when
    the query is finite."""
    p = rng.uniform(-10, 10, (600, 3))
    pm = rng.uniform(size=600) < 0.9
    q = rng.uniform(-12, 12, (300, 3))
    q[:40] = p[:40]
    r2 = rng.choice([-1.0, 0.0, 1.0, 4.0], 300)
    some_q = rng.uniform(size=300) < 0.2
    some_p = rng.uniform(size=(600, 1)) < 0.1
    bad = np.where(rng.uniform(size=(600, 3)) < 0.5, np.nan, 0.0)
    signed_inf = rng.choice([-np.inf, np.inf], (600, 3))
    if kind == "nan_radius":
        r2[some_q] = np.nan
    elif kind == "all_radii_nan":
        r2[:] = np.nan
    elif kind == "inf_radius":
        r2[some_q] = np.inf
        r2[:3] = np.nan
    elif kind == "nan_support":
        p = np.where(some_p & np.isnan(bad), np.nan, p)
    elif kind in ("inf_support", "inf_support_inf_radius"):
        p = np.where(some_p & (rng.uniform(size=(600, 3)) < 0.5),
                     signed_inf, p)
        if kind == "inf_support_inf_radius":
            r2[some_q] = np.inf
    elif kind == "non_finite_queries":
        q[some_q] = rng.choice([np.nan, np.inf, -np.inf], (300, 3))[some_q]
        r2[rng.uniform(size=300) < 0.3] = np.inf
    else:  # every valid point has a NaN or infinite coordinate
        p[:, rng.integers(0, 3)] = rng.choice([np.nan, np.inf, -np.inf],
                                              600)
        r2[:100] = np.inf
    return q, p, pm, r2


@pytest.mark.parametrize("kind", NON_FINITE_KINDS)
def test_non_finite_radii_and_coordinates(kind):
    """The index takes its box from the finite valid points and its side
    from the largest non-NaN radius, and the walk over it still gives the
    plain version's counts."""
    q, p, pm, r2 = non_finite_case(kind, np.random.default_rng(31))
    counts = _check(q, p, pm, r2)
    assert bool(torch.isfinite(counts).all())
    if kind in ("inf_radius", "inf_support_inf_radius", "non_finite_queries",
                "no_finite_support"):
        index = kernels.cell_index(
            torch.as_tensor(p, dtype=torch.float32), torch.as_tensor(pm),
            torch.as_tensor(r2, dtype=torch.float32))
        assert index.h == float("inf") and index.dims == (1, 1, 1)


@pytest.mark.parametrize("extent", [1.0, 1000.0, 1.0e5])
def test_the_index_is_linear_in_the_support(extent):
    """The index holds the valid points and their keys, sorted, and
    nothing sized by the box: its memory is O(P) at any extent."""
    rng = np.random.default_rng(11)
    n = 5000
    p = torch.as_tensor(rng.uniform(-extent, extent, (n, 3)),
                        dtype=torch.float32)
    pm = torch.as_tensor(rng.uniform(size=n) < 0.8)
    r2 = torch.full((10,), 0.05 ** 2)
    index = kernels.cell_index(p, pm, r2)
    held = sum(t.numel() * t.element_size()
               for t in (index.points, index.keys, index.lo))
    assert held <= 24 * int(pm.sum()) + 64  # float4 + int64 a point
    assert index.points.shape == (int(pm.sum()), 4)
    assert bool((index.points[:, 3] == 1).all())
    assert bool((index.keys[1:] >= index.keys[:-1]).all())
    # the same points as the valid support, each with its own cell's key
    got = index.points[:, :3]
    assert torch.equal(torch.sort(got[:, 0]).values,
                       torch.sort(p[pm][:, 0]).values)
    cells = kernels._cells(got, index.lo, index.top, index.h)
    assert torch.equal(kernels._keys(cells, index.dims), index.keys)
    assert index.h >= 0.05


def test_candidate_pairs_count_the_walk():
    """candidate_pairs is the sum of the walk's range sizes over queries
    with r2 >= 0, at most Q x P, and covers every hit."""
    rng = np.random.default_rng(12)
    p = torch.as_tensor(rng.uniform(-20, 20, (3000, 3)), dtype=torch.float32)
    pm = torch.as_tensor(rng.uniform(size=3000) < 0.9)
    q = torch.as_tensor(rng.uniform(-25, 25, (400, 3)), dtype=torch.float32)
    r2 = torch.as_tensor(rng.choice([-1.0, 1.0, 4.0], 400),
                         dtype=torch.float32)
    cand = kernels.candidate_pairs(q, p, pm, r2)
    index = kernels.cell_index(p, pm, r2)
    order, cells = kernels.query_cells(q, index)
    start, end = kernels.neighbour_ranges(cells, index)
    sizes = (end - start).sum(1)
    assert cand == int(sizes[r2[order] >= 0].sum())
    hits = int(kernels.count_within_plain(q, p, pm, r2).sum())
    assert hits <= cand <= 400 * int(pm.sum())
