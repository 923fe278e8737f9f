"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card: the CUDA
kernels have no CPU mode.  The file imports neither JAX nor the JAX
package, so on a machine with a card it runs without the suite's
conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The kernels form squared distances exactly as the plain versions do, so
nearest-neighbor indices and distances and all counts are compared for
equality; other sums differ only by summation order (stated below).  The
roofline probe's two kernels (``count_within``, ``adj_stack``) are held to
their plain versions the same way."""

import numpy as np
import pytest
import torch

from mulls_tpu_torch.ops import kernels
from mulls_tpu_torch.ops.neighbors import cov_from_moments
from mulls_tpu_torch.tools import roofline as rf
from test_torch_cells import NON_FINITE_KINDS, non_finite_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _clouds(dev, seed, qn, pn, valid=0.9, extent=40.0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-extent, extent, (qn, 3)).astype(np.float32)
    p = rng.uniform(-extent, extent, (pn, 3)).astype(np.float32)
    qm = rng.uniform(size=qn) < valid
    pm = rng.uniform(size=pn) < valid
    return [torch.from_numpy(a).to(dev) for a in (q, qm, p, pm)]


# sizes below, at and above the query tile (128), the stage (256) and the
# largest support chunk (1024) of pca_moments and nn; 1536 x 1536 is the map
# refresh's shape, where pca_moments halves its chunk to 128
_SIZES = [(1, 1), (127, 255), (128, 256), (129, 1025), (700, 5000),
          (1536, 1536), (8192, 8192)]
# below, at and above nn's query tile (128), stage (256) and chunk (1024)
_NN_SIZES = [(1, 1), (127, 255), (128, 256), (129, 257), (128, 1024),
             (129, 1025), (700, 5000), (1200, 8192)]


@pytest.mark.parametrize("qn,pn", _SIZES)
def test_nn_kernel_equals_plain(dev, qn, pn):
    q, qm, p, pm = _clouds(dev, 1, qn, pn)
    idx, d2 = kernels.nn(q, qm, p, pm)
    ridx, rd2 = kernels.nn_plain(q, qm, p, pm)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    assert torch.equal(d2, rd2)
    v = qm & (rd2 < 1e30)
    assert torch.equal(idx[v], ridx[v])


def _nn_problem(dev, seed, qn, pn, kind="random"):
    q, qm, p, pm = _clouds(dev, seed, qn, pn)
    if kind == "no_support":
        pm = torch.zeros_like(pm)
    elif kind == "duplicates":
        # every support point twice, the copies interleaved: each nearest
        # point is tied, and the lower index must win
        p = p.repeat_interleave(2, dim=0)
        pm = torch.ones(2 * pn, dtype=torch.bool, device=dev)
    return q, qm, p, pm


@pytest.mark.parametrize("n", range(1, 9))
def test_nn_grouped_kernel_equals_plain_bit_for_bit(dev, n):
    kinds = ["random", "duplicates", "no_support"]
    probs = [_nn_problem(dev, 10 * n + k, *_NN_SIZES[(n + k) % 8],
                         kind=kinds[k % 3])
             for k in range(n)]
    kernels.reset_launch_counts()
    got = kernels.nn_grouped(probs)
    want = kernels.nn_grouped_plain(probs)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["nn_grouped"] == 1
    for k, ((idx, d2), (ridx, rd2)) in enumerate(zip(got, want)):
        assert torch.equal(d2, rd2), k
        assert torch.equal(idx, ridx), k
    if n >= 2:  # the duplicated support: the copy at the odd index never wins
        assert torch.all(got[1][0] % 2 == 0)


def test_nn_grouped_kernel_edge_members_and_splitting(dev):
    """An empty member, Q = 1, P = 1, and more problems with queries than
    one launch takes (NN_MAX_GROUP: two launches): every member equals its
    plain version."""
    sizes = [(0, 30), (1, 1), (1, 5000), (300, 1), (64, 2048), (1200, 8192),
             (200, 512), (800, 6144), (400, 1536), (129, 1025)]
    sizes = sizes * 6  # 6 empty, 54 with queries
    assert kernels.NN_MAX_GROUP < len(sizes) - 6 <= 2 * kernels.NN_MAX_GROUP
    probs = [_nn_problem(dev, 40 + k, qn, pn)
             for k, (qn, pn) in enumerate(sizes)]
    kernels.reset_launch_counts()
    got = kernels.nn_grouped(probs)
    want = kernels.nn_grouped_plain(probs)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["nn_grouped"] == 2
    assert kernels.launch_counts()["nn"] == 2
    for (idx, d2), (ridx, rd2) in zip(got, want):
        assert torch.equal(idx, ridx) and torch.equal(d2, rd2)


def test_nn_and_moments_kernels_repeat_their_bits(dev):
    probs = [_nn_problem(dev, 50 + k, qn, pn) for k, (qn, pn) in enumerate(
        [(800, 6144), (400, 1536), (1200, 8192), (200, 1024), (200, 512)])]
    first = kernels.nn_grouped(probs)
    second = kernels.nn_grouped(probs)
    for a, b in zip(first, second):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    q, _, p, pm = _clouds(dev, 51, 4096, 20480, extent=20.0)
    r2 = torch.full((4096,), 9.0, device=dev)  # ~37 neighbors a query
    g = torch.Generator(device=dev).manual_seed(5)
    feats = torch.rand((20480, 6), generator=g, device=dev)
    a = kernels.moments(q, p, pm, r2, feats, 0.3 * r2)
    b = kernels.moments(q, p, pm, r2, feats, 0.3 * r2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _batch(dev, seed, n_seq, qn, pn, c=6):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)
    q = t(rng.uniform(-8, 8, (n_seq, qn, 3)).astype(np.float32))
    p = t(rng.uniform(-8, 8, (n_seq, pn, 3)).astype(np.float32))
    qm = t(rng.uniform(size=(n_seq, qn)) < 0.9)
    pm = t(rng.uniform(size=(n_seq, pn)) < 0.8)
    r2 = t(rng.uniform(0.3, 2.5, (n_seq, qn)).astype(np.float32))
    f = t(rng.uniform(-1, 1, (n_seq, pn, c)).astype(np.float32))
    return q, qm, p, pm, r2, f


@pytest.mark.parametrize("n_seq", [1, 2, 3, 8])
@pytest.mark.parametrize("qn,pn", [(1, 1), (200, 512), (1200, 8192),
                                   (1025, 2049)])
def test_batched_kernels_equal_single_launches_bit_for_bit(dev, n_seq, qn,
                                                           pn):
    """One launch for a batch of ``n_seq`` problems gives each entry the
    bits of its own launch, for nn (grouped, two classes), moments (with
    close sums) and pca_moments; one launch each."""
    q, qm, p, pm, r2, f = _batch(dev, 7 * n_seq + qn, n_seq, qn, pn)
    kernels.reset_launch_counts()
    nn_b = kernels.nn_grouped([(q, qm, p, pm), (p, pm, q, qm)])
    mom_b = kernels.moments(q, p, pm, r2, f, 0.4 * r2)
    pca_b = kernels.pca_moments(q, p, pm, r2)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "nn": 1, "nn_grouped": 1, "moments": 1, "pca_moments": 1,
        "count_within": 0}
    for s in range(n_seq):
        nn_s = kernels.nn_grouped([(q[s], qm[s], p[s], pm[s]),
                                   (p[s], pm[s], q[s], qm[s])])
        mom_s = kernels.moments(q[s], p[s], pm[s], r2[s], f[s],
                                0.4 * r2[s])
        pca_s = kernels.pca_moments(q[s], p[s], pm[s], r2[s])
        for a, b in ((nn_b[0], nn_s[0]), (nn_b[1], nn_s[1]), (mom_b, mom_s),
                     (pca_b, pca_s)):
            for x, y in zip(a, b):
                assert torch.equal(x[s], y), s
        # and the plain version on the entry
        ridx, rd2 = kernels.nn_plain(q[s], qm[s], p[s], pm[s])
        assert torch.equal(nn_b[0][1][s], rd2)
        rc, _, _ = kernels.pca_moments_plain(q[s], p[s], pm[s], r2[s])
        assert torch.equal(pca_b[0][s], rc)


def test_batched_nn_at_the_icp_shapes_of_eight_sequences(dev):
    """Five ICP classes of eight sequences: 40 problems, one launch, each
    entry its single launch's bits."""
    shapes = [(800, 6144), (400, 1536), (1200, 8192), (200, 1024),
              (200, 512)]
    batches = [_batch(dev, 300 + k, 8, qn, pn)[:4]
               for k, (qn, pn) in enumerate(shapes)]
    kernels.reset_launch_counts()
    got = kernels.nn_grouped(batches)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["nn"] == 1
    for (q, qm, p, pm), (idx, d2) in zip(batches, got):
        for s in range(8):
            i1, d1 = kernels.nn(q[s], qm[s], p[s], pm[s])
            assert torch.equal(idx[s], i1) and torch.equal(d2[s], d1)


def test_nn_kernel_with_no_valid_support(dev):
    q, qm, p, _ = _clouds(dev, 2, 100, 300)
    pm = torch.zeros(300, dtype=torch.bool, device=dev)
    idx, d2 = kernels.nn(q, qm, p, pm)
    assert torch.all(d2 > 1e30)
    assert torch.all(idx == 0)  # the reference's argmin over +BIG


@pytest.mark.parametrize("c", [1, 6, 16])
@pytest.mark.parametrize("close", [False, True])
@pytest.mark.parametrize("qn,pn", [
    (700, 5000), (1, 5000), (129, kernels.MOMENTS_CHUNK + 1),
    (128, 2 * kernels.MOMENTS_CHUNK)])
def test_moments_kernel_equals_plain(dev, c, close, qn, pn):
    """P off and on a multiple of the support chunk, Q = 1, and Q off and
    on a multiple of the 128-query tile."""
    q, _, p, pm = _clouds(dev, 3, qn, pn, extent=20.0)
    r2 = torch.full((qn,), 9.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    feats = torch.rand((pn, c), generator=g, device=dev)
    feats[:, 0] = 1.0  # a count column: exact on both sides
    cr2 = 0.5 * r2 if close else None
    s, cs = kernels.moments(q, p, pm, r2, feats, cr2)
    rs, rcs = kernels.moments_plain(q, p, pm, r2, feats, cr2)
    assert torch.equal(s[:, 0], rs[:, 0])
    # fp32 sums of ~100 terms in [0, 1) in another order
    assert torch.allclose(s, rs, rtol=1e-5, atol=1e-4)
    if close:
        assert torch.equal(cs[:, 0], rcs[:, 0])
        assert torch.allclose(cs, rcs, rtol=1e-5, atol=1e-4)
    else:
        assert cs is None and rcs is None


def test_moments_kernel_rejects_wide_features(dev):
    q, _, p, pm = _clouds(dev, 5, 10, 20)
    with pytest.raises(ValueError):
        kernels.moments(q, p, pm, torch.ones(10, device=dev),
                        torch.ones((20, kernels.MOMENTS_MAX_C + 1),
                                   device=dev))


def _same_bits(fn) -> bool:
    a, b = fn(), fn()
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("qn,pn", _SIZES)
def test_pca_moments_kernel_equals_plain(dev, qn, pn):
    q, _, p, pm = _clouds(dev, 6, qn, pn, extent=10.0)
    r2 = torch.full((qn,), 4.0, device=dev)
    ck, sk, ok = kernels.pca_moments(q, p, pm, r2)
    cp, sp, op = kernels.pca_moments_plain(q, p, pm, r2)
    assert torch.equal(ck, cp)
    # covariances of 2 m neighborhoods (~1 m^2), both sides centred at the
    # query and summed in fp32 in another order: a few ulp of ~1 m^2
    assert torch.allclose(cov_from_moments(ck, sk, ok),
                          cov_from_moments(cp, sp, op), rtol=1e-6, atol=1e-6)
    # chunks merged in chunk order, no float atomics
    assert _same_bits(lambda: kernels.pca_moments(q, p, pm, r2))


def test_pca_moments_kernel_with_a_radius_per_query(dev):
    """Distance-adaptive radii: 0.5 to 3 m, one a query."""
    q, _, p, pm = _clouds(dev, 10, 3000, 9000, extent=10.0)
    g = torch.Generator(device=dev).manual_seed(11)
    r2 = (0.5 + 2.5 * torch.rand((3000,), generator=g, device=dev)) ** 2
    ck, sk, ok = kernels.pca_moments(q, p, pm, r2)
    cp, sp, op = kernels.pca_moments_plain(q, p, pm, r2)
    assert torch.equal(ck, cp)
    assert torch.allclose(cov_from_moments(ck, sk, ok),
                          cov_from_moments(cp, sp, op), rtol=1e-6, atol=1e-6)
    assert _same_bits(lambda: kernels.pca_moments(q, p, pm, r2))


def test_pca_moments_kernel_when_every_pair_hits(dev):
    """r covers the whole 2 m cube: every vote fires and every valid pair
    adds, across five support chunks."""
    q, _, p, pm = _clouds(dev, 12, 300, 5000, extent=1.0)
    r2 = torch.full((300,), 100.0, device=dev)
    ck, sk, ok = kernels.pca_moments(q, p, pm, r2)
    assert torch.all(ck == pm.sum().float())
    cp, sp, op = kernels.pca_moments_plain(q, p, pm, r2)
    assert torch.equal(ck, cp)
    # ~4500 terms of up to ~1 m^2 a query, summed in fp32 in another order:
    # the sums agree to ~1e-5 relative, the covariances (~0.33 m^2) to well
    # within 1e-6 m^2 once divided by the count
    want = kernels.pca_moments_plain(q.double(), p.double(), pm, r2.double())
    for got, ref in zip((sk, ok), want[1:]):
        assert torch.allclose(got.double(), ref, rtol=1e-5, atol=1e-3)
    assert torch.allclose(cov_from_moments(ck, sk, ok).double(),
                          cov_from_moments(*want), rtol=1e-5, atol=1e-6)
    assert _same_bits(lambda: kernels.pca_moments(q, p, pm, r2))


def test_pca_moments_kernel_edges(dev):
    """No valid support (zeros), no support at all, and no queries (no
    launch)."""
    q, _, p, _ = _clouds(dev, 13, 300, 5000)
    r2 = torch.full((300,), 9.0, device=dev)
    none = torch.zeros(5000, dtype=torch.bool, device=dev)
    for pp, pm in ((p, none), (p[:0], none[:0])):
        ck, sk, ok = kernels.pca_moments(q, pp, pm, r2)
        assert torch.all(ck == 0) and torch.all(sk == 0) and torch.all(ok == 0)
    kernels.reset_launch_counts()
    ck, sk, ok = kernels.pca_moments(q[:0], p, none, r2[:0])
    assert ck.shape == (0,) and sk.shape == (0, 3) and ok.shape == (0, 6)
    assert kernels.launch_counts()["pca_moments"] == 0


def test_pca_moments_kernel_keeps_plane_thickness_far_out(dev):
    """The smallest eigenvalue of a 2 mm-thick plane 100 m out, which the
    normals and the classification read: sums centred anywhere but near
    the query would lose it in fp32."""
    rng = np.random.default_rng(9)
    n = 4000
    p = np.stack([100.0 + rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                  0.002 * rng.normal(size=n)], 1).astype(np.float32)
    p = torch.from_numpy(p).to(dev)
    q = p[:200].contiguous()
    cnt, sx, so = kernels.pca_moments(q, p, torch.ones(n, dtype=torch.bool,
                                                       device=dev),
                                      torch.full((200,), 1.0, device=dev))
    cov = cov_from_moments(cnt, sx, so).double().cpu()
    lam3 = torch.linalg.eigvalsh(cov)[:, 0]
    # true lambda_3 is 4e-6 m^2; sampling spreads it by well under 2e-6
    assert torch.all((lam3 - 4e-6).abs() < 2e-6)


def test_cuda_tensors_launch_the_kernels_and_count_once(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("nn_plain", "moments_plain", "pca_moments_plain"):
        monkeypatch.setattr(kernels, name, refuse)
    q, qm, p, pm = _clouds(dev, 7, 200, 900)
    r2 = torch.full((200,), 9.0, device=dev)
    for name in ("nn_grouped_plain",):
        monkeypatch.setattr(kernels, name, refuse)
    kernels.reset_launch_counts()
    kernels.nn(q, qm, p, pm)
    kernels.nn_grouped([(q, qm, p, pm), (p, pm, q, qm)])
    kernels.moments(q, p, pm, r2, torch.ones((900, 1), device=dev))
    kernels.pca_moments(q, p, pm, r2)
    torch.cuda.synchronize()
    # nn counts every launch of its kernel, nn_grouped its own
    assert kernels.launch_counts() == {"nn": 2, "nn_grouped": 1,
                                       "moments": 1, "pca_moments": 1,
                                       "count_within": 0}


def test_wrappers_refuse_mixed_devices(dev):
    q, qm, p, pm = _clouds(dev, 8, 20, 40)
    with pytest.raises(ValueError):
        kernels.nn(q, qm, p.cpu(), pm.cpu())


# --- the roofline probe's kernels (mulls_tpu_torch/tools/roofline.py)

# count_within takes one query a thread (128 a block) and walks a cell grid,
# so its sizes matter only as counts of queries and points; adj_stack's
# geometry: the warpgroup's m-tile (64 queries) and the block's tile (128),
# the TMA stage (128 points), the k-step (16) and the cluster's eight parts
# of the support in whole stages (P = 1024: one stage a block; 1025: two,
# the last block's mostly past the end)
_PROBE_SIZES = [(1, 1), (63, 15), (64, 16), (65, 17), (127, 127),
                (128, 128), (129, 129), (130, 1024), (130, 1025),
                (257, 2049), (700, 5000), (300, 9000)]


def _probe_cloud(dev, seed, qn, pn):
    """~30 neighbours a query, 10 % invalid support."""
    q, _, p, pm = _clouds(dev, seed, qn, pn, extent=6.0)
    r2 = torch.full((qn,), 1.5, device=dev)
    return q, p, pm, r2


@pytest.mark.parametrize("qn,pn", _PROBE_SIZES)
def test_count_within_kernel_equals_plain(dev, qn, pn):
    q, p, pm, r2 = _probe_cloud(dev, 20, qn, pn)
    rf.reset_launch_counts()
    got = rf.count_within(q, p, pm, r2)
    assert got.dtype == torch.float32 and got.shape == (qn,)
    assert torch.equal(got, rf.count_within_plain(q, p, pm, r2))
    # a second launch gives the same bits
    assert torch.equal(rf.count_within(q, p, pm, r2), got)
    assert rf.launch_counts()["count_within"] == 2


def _grid_case(kind, rng):
    """The inputs of tests/test_torch_cells.py's cases, as numpy."""
    if kind in NON_FINITE_KINDS:
        return non_finite_case(kind, rng)
    if kind == "lattice":  # on cell borders, exactly r apart
        p = 3.25 + rng.integers(-6, 7, (2000, 3)) * 0.25
        q = np.concatenate([p[:500], p[500:1500] + np.eye(3)[
            rng.integers(0, 3, 1000)] * 0.25])
        return q, p, np.ones(2000, bool), np.full(1500, 0.0625)
    if kind == "just_inside_r":
        q = rng.uniform(-50, 50, (4000, 3)).astype(np.float32)
        axis = np.eye(3)[rng.integers(0, 3, 4000)] * rng.choice([-1, 1],
                                                                (4000, 1))
        p = np.concatenate([q + axis * 0.49995, q + axis * 0.25])
        return q, p, np.ones(8000, bool), np.full(4000, 0.25)
    if kind in ("masked_far_radii", "empty_support", "no_valid_support"):
        n_p = 0 if kind == "empty_support" else 3000
        p = rng.uniform(-20, 20, (n_p, 3))
        pm = rng.uniform(size=n_p) < (0.0 if kind == "no_valid_support"
                                      else 0.7)
        q = rng.uniform(-20, 20, (1500, 3))
        far = rng.uniform(size=1500) < 0.33
        q[far] += rng.choice([-1, 1], (int(far.sum()), 3)) * 200.0
        q[:5] = p[:5] if n_p else q[:5]
        r2 = rng.choice([-1.0, 0.0, 1.0, 4.0, 25.0], 1500)
        return q, p, pm, r2
    if kind == "one_cell":
        p = rng.uniform(-0.3, 0.3, (3000, 3))
        q = rng.uniform(-0.6, 0.6, (1000, 3))
        return q, p, np.ones(3000, bool), rng.uniform(0.01, 4.0, 1000)
    # a kilometre at r = 0.05
    centres = rng.uniform(-500, 500, (200, 2))
    xy = centres[rng.integers(0, 200, 20000)] + rng.normal(0, 0.1,
                                                          (20000, 2))
    p = np.concatenate([xy, rng.uniform(-0.05, 0.05, (20000, 1))], 1)
    q = p[:3000] + rng.normal(0, 0.02, (3000, 3))
    return q, p, np.ones(20000, bool), np.full(3000, 0.0025)


@pytest.mark.parametrize("kind", ["lattice", "just_inside_r",
                                  "masked_far_radii", "empty_support",
                                  "no_valid_support", "one_cell", "km",
                                  *NON_FINITE_KINDS])
def test_count_within_kernel_on_the_grid_edge_cases(dev, kind):
    """The CPU index tests' cases on the card: exact, the same bits twice,
    each launch counted."""
    q, p, pm, r2 = _grid_case(kind, np.random.default_rng(24))
    q, p, r2 = (torch.tensor(np.asarray(a, np.float32), device=dev)
                for a in (q, p, r2))
    pm = torch.tensor(pm, device=dev)
    kernels.reset_launch_counts()
    got, again = (kernels.count_within(q, p, pm, r2),
                  kernels.count_within(q, p, pm, r2))
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.count_within_plain(q, p, pm, r2))
    assert torch.equal(got, again)
    assert kernels.launch_counts()["count_within"] == 2


@pytest.mark.parametrize("c", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("qn,pn", _PROBE_SIZES)
def test_adj_stack_kernel_equals_plain(dev, c, qn, pn):
    q, p, pm, r2 = _probe_cloud(dev, 21, qn, pn)
    g = torch.Generator(device=dev).manual_seed(c)
    # column-distinct integers (|value| <= 256, exact in bf16): the sums are
    # exact, and a transposed or misplaced fragment shows
    ints = (torch.arange(1, c + 1, device=dev, dtype=torch.float32)[None, :]
            * torch.randint(-2, 3, (pn, 1), generator=g, device=dev)
            ).to(torch.bfloat16)
    got = rf.adj_stack(q, p, pm, r2, ints)
    assert got.dtype == torch.float32 and got.shape == (qn, c)
    assert torch.equal(got, rf.adj_stack_plain(q, p, pm, r2, ints))
    # random bf16: fp32 sums in another order, rtol 1e-5 and atol 1e-5 x
    # the sum of |terms|
    f = torch.randn((pn, c), generator=g, device=dev).to(torch.bfloat16)
    got = rf.adj_stack(q, p, pm, r2, f)
    want = rf.adj_stack_plain(q, p, pm, r2, f)
    terms = rf.adj_stack_plain(q, p, pm, r2, f.abs())
    assert torch.all((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * terms)
    assert torch.equal(rf.adj_stack(q, p, pm, r2, f), got)


def test_probe_kernels_with_no_valid_support(dev):
    q, p, _, r2 = _probe_cloud(dev, 22, 300, 5000)
    pm = torch.zeros(5000, dtype=torch.bool, device=dev)
    assert torch.all(rf.count_within(q, p, pm, r2) == 0)
    f = torch.ones((5000, 32), dtype=torch.bfloat16, device=dev)
    assert torch.all(rf.adj_stack(q, p, pm, r2, f) == 0)


def test_probe_kernels_repeat_their_bits_at_the_probe_shape(dev):
    x = rf.probe_inputs(matmul_n=8)
    q = torch.from_numpy(x["q_map"]).to(dev)
    p = torch.from_numpy(x["p"]).to(dev)
    pm = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
    r2 = torch.ones(q.shape[0], device=dev)
    f = torch.randn((p.shape[0], 128), device=dev).to(torch.bfloat16)
    rf.reset_launch_counts()
    a, b = rf.adj_stack(q, p, pm, r2, f), rf.adj_stack(q, p, pm, r2, f)
    c, d = rf.count_within(q, p, pm, r2), rf.count_within(q, p, pm, r2)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)
    assert torch.equal(c, rf.count_within_plain(q, p, pm, r2))
    assert rf.launch_counts() == {"count_within": 2, "adj_stack": 2}


def test_probe_wrappers_launch_on_cuda_and_refuse_the_rest(dev, monkeypatch):

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(rf, "count_within_plain", refuse)
    monkeypatch.setattr(rf, "adj_stack_plain", refuse)
    q, p, pm, r2 = _probe_cloud(dev, 23, 50, 200)
    f = torch.ones((200, 16), dtype=torch.bfloat16, device=dev)
    rf.reset_launch_counts()
    rf.count_within(q, p, pm, r2)
    rf.adj_stack(q, p, pm, r2, f)
    torch.cuda.synchronize()
    assert rf.launch_counts() == {"count_within": 1, "adj_stack": 1}
    with pytest.raises(TypeError):
        rf.adj_stack(q, p, pm, r2, f.float())
    with pytest.raises(TypeError):
        rf.count_within(q.double(), p, pm, r2)
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        rf.count_within(*(t.to("meta") for t in (q, p, pm, r2)))
    with pytest.raises(ValueError):  # devices mixed
        rf.adj_stack(q, p.cpu(), pm.cpu(), r2, f)
    assert rf.launch_counts() == {"count_within": 1, "adj_stack": 1}


# --- the submap back end on the card (mulls_tpu_torch/backend)

# one map-to-map ICP iteration: strided sources (<= 4096) against the full
# submap targets of the default map capacities, the five ICP classes
_M2M_SHAPES = [(3072, 6144), (1536, 1536), (4096, 8192), (1024, 1024),
               (512, 512)]


def test_nn_grouped_at_the_map_to_map_shapes(dev):
    group = [_clouds(dev, 40 + k, qn, pn, valid=0.95)
             for k, (qn, pn) in enumerate(_M2M_SHAPES)]
    got = kernels.nn_grouped(group)
    again = kernels.nn_grouped(group)
    want = kernels.nn_grouped_plain(group)
    for (i, d), (i2, d2), (ri, rd) in zip(got, again, want):
        assert torch.equal(i, ri) and torch.equal(d, rd)
        assert torch.equal(i, i2) and torch.equal(d, d2)


def test_launch_counts_have_a_per_thread_view(dev):
    import threading
    q, qm, p, pm = _clouds(dev, 9, 300, 900)
    kernels.reset_launch_counts()
    seen = {}

    def other():
        with kernels.count_launches() as rec:
            kernels.nn_grouped([(q, qm, p, pm)] * 3)
        seen.update(rec)

    with kernels.count_launches() as mine:
        kernels.nn(q, qm, p, pm)
        th = threading.Thread(target=other)
        th.start()
        th.join()
    torch.cuda.synchronize()
    assert mine == {"nn": 1, "nn_grouped": 0, "moments": 0,
                    "pca_moments": 0, "count_within": 0}
    assert seen == {"nn": 1, "nn_grouped": 1, "moments": 0,
                    "pca_moments": 0, "count_within": 0}
    assert kernels.launch_counts()["nn"] == 2


def _submap(T, seed=7, n=128):
    """tests/test_bank.py's structured submap (ground, two walls, posts,
    shared descriptors) in the frame ``T`` maps into, as the port's
    clouds on the CPU."""
    from mulls_tpu_torch.core.cloud import FeatureCloud, VertexDescriptors
    rng = np.random.default_rng(seed)
    R, t = T[:3, :3], T[:3, 3]

    def cloud(xyz, normal, cap):
        k = xyz.shape[0]
        pad = np.zeros((cap - k, 3))
        f = lambda a: torch.tensor(np.asarray(a, np.float32))
        return FeatureCloud(
            xyz=f(np.concatenate([xyz @ R.T + t, pad])),
            normal=f(np.concatenate([normal @ R.T, pad])),
            intensity=torch.full((cap,), 0.5), strength=torch.full((cap,), 0.8),
            height=torch.zeros(cap), ts_ratio=torch.zeros(cap),
            mask=torch.arange(cap) < k)

    g = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                  rng.normal(0, 0.01, n)], -1)
    fx = np.stack([np.full(n, 8.0) + rng.normal(0, 0.01, n),
                   rng.uniform(-20, 20, n), rng.uniform(0, 6, n)], -1)
    fy = np.stack([rng.uniform(-20, 20, n),
                   np.full(n, -7.0) + rng.normal(0, 0.01, n),
                   rng.uniform(0, 6, n)], -1)
    nv = 24
    base = np.stack([rng.uniform(-15, 15, nv), rng.uniform(-15, 15, nv)], -1)
    p = np.concatenate([np.stack([base[:, 0] + rng.normal(0, 0.01, nv),
                                  base[:, 1] + rng.normal(0, 0.01, nv),
                                  np.full(nv, z)], -1)
                        for z in np.linspace(0, 4, 16)])
    v = np.concatenate([base, np.full((nv, 1), 4.0)], -1)
    up = lambda k: np.tile([0.0, 0.0, 1.0], (k, 1))
    none = np.zeros((0, 3))
    clouds = {
        "ground": cloud(g, up(n), 192),
        "facade": cloud(np.concatenate([fx, fy]), np.concatenate(
            [np.tile([1.0, 0, 0], (n, 1)), np.tile([0, 1.0, 0], (n, 1))]),
            384),
        "pillar": cloud(p, up(len(p)), 512),
        "beam": cloud(none, none, 64), "roof": cloud(none, none, 64),
        "vertex": cloud(v, up(nv), 64)}
    vec = np.zeros((64, 11), np.float32)
    vec[:nv] = rng.uniform(0, 60, (nv, 11))
    return clouds, VertexDescriptors(vec=torch.tensor(vec),
                                     mask=torch.arange(64) < nv)


def _to(tree, where):
    from mulls_tpu_torch.core.tree import tree_map
    return tree_map(lambda x: x.to(where), tree)


def test_bank_store_and_pair_m2m_on_the_card_match_the_cpu(dev):
    from mulls_tpu_torch.backend import bank as bk
    from mulls_tpu_torch.config import MullsConfig
    cfg = MullsConfig()
    T_true = np.eye(4)
    T_true[:3, 3] = [0.4, -0.25, 0.05]
    a, b = _submap(np.eye(4)), _submap(np.linalg.inv(T_true))
    rows = {}
    for where in (dev, torch.device("cpu")):
        bank = bk.init_bank(_to(a[0], where), _to(a[1], where), capacity=4)
        bk.bank_store(bank, 0, _to(a[0], where), _to(a[1], where))
        bk.bank_store(bank, 2, _to(b[0], where), _to(b[1], where))
        assert torch.equal(bank.clouds["facade"].xyz[2].cpu(),
                           b[0]["facade"].xyz)
        rows[where.type] = bk.pair_m2m(bank, 0, 2, torch.eye(4,
                                       device=where), cfg,
                                       cfg.reg.reg_max_iter_num_m2m).cpu()
    card, cpu = bk.unpack_reg(rows["cuda"]), bk.unpack_reg(rows["cpu"])
    assert card["code"] == cpu["code"] == 1
    assert card["iterations"] == cpu["iterations"]
    np.testing.assert_allclose(card["T"], cpu["T"], atol=1e-4)
    np.testing.assert_allclose(card["T"][:3, 3], T_true[:3, 3], atol=0.05)


def test_slam_backend_on_the_card_with_a_bank_of_two(dev):
    """Five submaps of one structured world along a line, a bank of two
    slots: evictions, the host path for loop candidates, PGO; the card's
    decisions equal the CPU's and its poses agree to 1 cm."""
    import dataclasses

    from mulls_tpu_torch.backend.submap import SlamBackend
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.core.draws import GeneratorDraws
    from mulls_tpu_torch.mapping.local_map import LocalMap
    base = MullsConfig()
    cfg = base.replace(submap=dataclasses.replace(
        base.submap, loop_closure_detection_on=True, min_submap_id_diff=3,
        neighbor_search_dist=30.0, min_iou_thre=0.2,
        teaser_min_inlier_count=6, submap_bank_capacity=2))
    poses = []
    for k in range(5):
        P = np.eye(4)
        P[:3, 3] = [3.0 * k, 0.4 * k, 0.0]
        poses.append(P)
    runs = {}
    for where in (dev, torch.device("cpu")):
        be = SlamBackend(cfg, where)
        for k, P in enumerate(poses):
            clouds, desc = _submap(np.linalg.inv(P))
            prior = P.copy()
            prior[1, 3] += 0.05 * k  # odometry drift
            be.add_submap(LocalMap(clouds=_to(clouds, where),
                                   vertex_desc=_to(desc, where)),
                          prior, k, k)
            be.on_new_submap(GeneratorDraws(k, "cpu"))
        runs[where.type] = be
    card, cpu = runs["cuda"], runs["cpu"]
    assert any("evicted" in ev for ev in card.events)
    assert ([(e.i, e.j, e.kind) for e in card.edges]
            == [(e.i, e.j, e.kind) for e in cpu.edges])
    assert any(e.kind == 2 for e in card.edges), card.events
    for s, r in zip(card.submaps, cpu.submaps):
        np.testing.assert_allclose(s.pose[:3, 3], r.pose[:3, 3], atol=0.01)
    assert card.launches["nn"] > 0 and cpu.launches["nn"] == 0


# --- order-fixed float sums: the same input gives the same bits on every
# run (float atomics would add in the scheduler's order)

def test_ground_filter_repeats_its_bits_on_a_full_width_frame(dev):
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.core.draws import GeneratorDraws
    from mulls_tpu_torch.ops.ground import fast_ground_filter
    cfg = MullsConfig()
    n = cfg.shapes.n_raw
    rng = np.random.default_rng(50)
    xyz = np.concatenate([
        np.stack([rng.uniform(-60, 60, n // 2), rng.uniform(-60, 60, n // 2),
                  0.03 * rng.normal(size=n // 2) - 1.7], -1),
        rng.uniform([-60, -60, -1.5], [60, 60, 6.0], (n - n // 2, 3))])
    xyz = torch.tensor(xyz, dtype=torch.float32, device=dev)
    inten = torch.tensor(rng.uniform(0, 1, n), dtype=torch.float32,
                         device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    runs = [fast_ground_filter(xyz, inten, mask, cfg.ground, cfg.shapes,
                               GeneratorDraws(3, dev)) for _ in range(2)]
    assert int(runs[0].is_ground.sum()) > 1000
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _graph(dev, m=16, seed=60):
    """A 16-node chain with three loop edges, noisy measurements, node 0
    fixed, as the back end builds it."""
    from mulls_tpu_torch.backend.pgo import PoseGraph
    from mulls_tpu_torch.core import se3
    rng = np.random.default_rng(seed)
    yaw = np.cumsum(rng.normal(0, 0.1, m))
    t = np.cumsum(rng.normal(0, 2.0, (m, 3)) * [1, 1, 0.1], 0)
    R = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]] for a in yaw])
    T = np.tile(np.eye(4), (m, 1, 1))
    T[:, :3, :3], T[:, :3, 3] = R, t
    pairs = [(k, k + 1) for k in range(m - 1)] + [(0, 8), (3, 12), (5, 15)]
    meas = np.stack([np.linalg.inv(T[i]) @ T[j] for i, j in pairs])
    meas[:, :3, 3] += rng.normal(0, 0.05, (len(pairs), 3))
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    drift = T.copy()
    drift[:, :3, 3] += np.cumsum(rng.normal(0, 0.1, (m, 3)), 0)
    return PoseGraph(
        node_t=f(drift[:, :3, 3]),
        node_q=se3.quat_from_rotation(f(drift[:, :3, :3])),
        fixed=torch.arange(m, device=dev) == 0,
        edge_i=torch.tensor([i for i, _ in pairs], device=dev),
        edge_j=torch.tensor([j for _, j in pairs], device=dev),
        edge_t=f(meas[:, :3, 3]),
        edge_q=se3.quat_from_rotation(f(meas[:, :3, :3])),
        edge_info=f(np.tile(np.eye(6) * 100.0, (len(pairs), 1, 1))),
        edge_mask=torch.ones(len(pairs), dtype=torch.bool, device=dev))


def test_dense_pgo_repeats_its_bits(dev):
    from mulls_tpu_torch.backend.pgo import (optimize_pose_graph,
                                             optimize_pose_graph_cg)
    g = _graph(dev)
    for solve in (optimize_pose_graph, optimize_pose_graph_cg):
        a, b = solve(g), solve(g)
        for x, y in zip(a, b):
            assert torch.equal(x, y), solve.__name__
        assert float(a[2]) < float(solve(g, iterations=0)[2])


@pytest.mark.parametrize("mode", ["ndt", "gicp"])
def test_voxel_table_repeats_its_bits_on_a_full_map(dev, mode):
    from mulls_tpu_torch.ops.baseline_reg import build_voxel_table
    rng = np.random.default_rng(61)
    n = 40960  # BaselineConfig.map_budget
    xyz = torch.tensor(rng.uniform([-50, -50, -2], [50, 50, 8], (n, 3)),
                       dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.uniform(size=n) < 0.9, device=dev)
    a = build_voxel_table(xyz, mask, 1.5, mode=mode)
    b = build_voxel_table(xyz, mask, 1.5, mode=mode)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    c = build_voxel_table(xyz.cpu(), mask.cpu(), 1.5, mode=mode)
    assert torch.equal(a.count.cpu(), c.count)
    torch.testing.assert_close(a.mean.cpu(), c.mean, rtol=0, atol=2e-5)


# --- the slice's kernels at its own shapes, through ops/kernels.py

def test_count_within_at_the_map_assembly_shape(dev):
    """4096 queries of a 10^6-point map against all of it: exact, the same
    bits twice (the plain version in 256-query slices)."""
    rng = np.random.default_rng(62)
    p = torch.tensor(rng.uniform([-100, -100, -2], [100, 100, 10],
                                 (1_000_000, 3)), dtype=torch.float32,
                     device=dev)
    pm = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
    q = p[:4096].contiguous()
    r2 = torch.ones(4096, device=dev)
    kernels.reset_launch_counts()
    got, again = (kernels.count_within(q, p, pm, r2),
                  kernels.count_within(q, p, pm, r2))
    want = torch.cat([kernels.count_within_plain(q[s:s + 256], p, pm,
                                                 r2[s:s + 256])
                      for s in range(0, 4096, 256)])
    assert torch.equal(got, want) and torch.equal(got, again)
    assert float(got.min()) >= 1.0  # each query counts itself
    assert kernels.launch_counts()["count_within"] == 2


def test_pca_moments_at_the_gicp_shape(dev):
    """The GICP source covariances' call: 16384 x 16384 at r = 1.0
    (BaselineConfig.frame_budget, gicp_cov_radius), Morton-ordered
    queries; counts exact, covariances within 1e-6 m^2, same bits."""
    from mulls_tpu_torch.ops.pca import morton_order
    rng = np.random.default_rng(63)
    n = 16384
    g = np.stack([rng.uniform(-40, 40, n), rng.uniform(-40, 40, n),
                  0.02 * rng.normal(size=n) - 1.7], -1)
    p = torch.tensor(g, dtype=torch.float32, device=dev)
    pm = torch.tensor(rng.uniform(size=n) < 0.97, device=dev)
    q = p[morton_order(p)].contiguous()
    r2 = torch.ones(n, device=dev)
    ck, sk, ok_ = kernels.pca_moments(q, p, pm, r2)
    cp, sp, op = kernels.pca_moments_plain(q, p, pm, r2)
    assert torch.equal(ck, cp)
    err = (cov_from_moments(ck, sk, ok_) - cov_from_moments(cp, sp, op))
    assert float(err.abs().max()) <= 1e-6
    assert _same_bits(lambda: kernels.pca_moments(q, p, pm, r2))


def test_radius_outlier_filter_runs_on_the_card(dev, monkeypatch):
    """No host fallback: the plain count refuses, the kernel counts; the
    card keeps what the CPU keeps."""
    from mulls_tpu_torch.mapping.assembly import radius_outlier_filter
    rng = np.random.default_rng(64)
    pts = np.concatenate([rng.uniform(-5, 5, (20000, 3)),
                          rng.uniform(-200, 200, (500, 3))]).astype(
                              np.float32)
    want = radius_outlier_filter(pts, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(kernels, "count_within_plain", refuse)
    kernels.reset_launch_counts()
    got = radius_outlier_filter(pts)
    assert kernels.launch_counts()["count_within"] == 1
    np.testing.assert_array_equal(got, want)
    assert len(pts) - 500 <= len(got) < len(pts)


class _HostDraws:
    """Draws made by one CPU generator and moved to ``where``: the card and
    the CPU see the same numbers."""

    def __init__(self, seed, where):
        self.where, self.gen = where, torch.Generator().manual_seed(seed)

    def split(self, k):
        return [self] * k

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.gen).to(self.where)

    def bits(self, shape):
        return torch.randint(0, 1 << 32, tuple(shape), generator=self.gen,
                             dtype=torch.int64).to(self.where)


@pytest.mark.parametrize("method", ["ndt", "gicp"])
def test_baseline_pipeline_runs_on_the_card(dev, method, monkeypatch):
    """BaselinePipeline on the card (the plain PCA moments refuse): codes
    1 on a straight drive, the card within 2 cm / 0.2 deg of the CPU with
    the same draws, and pca_moments launched for GICP."""
    import dataclasses

    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.pipeline.baseline import BaselinePipeline
    base = MullsConfig()
    # the budgets of the CPU parity test (tests/test_torch_baseline.py)
    cfg = base.replace(baseline=dataclasses.replace(
        base.baseline, method=method, frame_budget=4096, map_budget=8192,
        table_resolution=1.8, voxel_down_size=0.5, max_iter=20))
    rng = np.random.default_rng(65)
    n = 30000
    world = np.concatenate([
        np.stack([rng.uniform(-40, 40, n), rng.uniform(-40, 40, n),
                  0.03 * rng.normal(size=n) - 1.7], -1),
        np.stack([np.where(rng.uniform(size=n) < 0.5, 12.0, -9.0)
                  + 0.03 * rng.normal(size=n), rng.uniform(-40, 40, n),
                  rng.uniform(-1.5, 4.0, n)], -1),
        np.stack([rng.uniform(-40, 40, n), np.full(n, 25.0)
                  + 0.03 * rng.normal(size=n), rng.uniform(-1.5, 4.0, n)],
                 -1)]).astype(np.float32)
    frames = []
    for k in range(5):
        local = world - np.float32([0.6 * k, 0.0, 0.0])
        keep = np.linalg.norm(local[:, :2], axis=1) < 30.0
        xyz = np.zeros((cfg.shapes.n_raw, 3), np.float32)
        m = np.zeros(cfg.shapes.n_raw, bool)
        sel = local[keep][:cfg.shapes.n_raw]
        xyz[:len(sel)], m[:len(sel)] = sel, True
        frames.append({"xyz": xyz, "intensity": np.zeros(cfg.shapes.n_raw,
                                                         np.float32),
                       "ts_ratio": np.zeros(cfg.shapes.n_raw, np.float32),
                       "mask": m})

    cpu = BaselinePipeline(cfg, device="cpu",
                           draws=_HostDraws(7, "cpu")).run(frames)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(kernels, "pca_moments_plain", refuse)
    kernels.reset_launch_counts()
    card = BaselinePipeline(cfg, device=dev,
                            draws=_HostDraws(7, dev)).run(frames)
    assert card.codes == cpu.codes == [1] * 5
    rel = lambda P: np.linalg.inv(P[:-1]) @ P[1:]
    for a, b in zip(rel(card.poses), rel(cpu.poses)):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.02
    np.testing.assert_allclose(np.diff(card.poses[:, 0, 3])[1:], 0.6,
                               atol=0.1)
    assert (kernels.launch_counts()["pca_moments"] > 0) == (method == "gicp")


def test_nn_at_the_sac_ia_scoring_shape(dev):
    """kernels.nn at FPFH-SAC's scoring call: 512 hypotheses x 256 scoring
    points (131,072 queries in one launch) against a 2,000-point target,
    5 % of it masked: bit-equal to the plain version, same bits twice."""
    rng = np.random.default_rng(81)
    tgt = np.concatenate([
        np.stack([rng.uniform(-30, 30, 800), rng.uniform(-30, 30, 800),
                  np.full(800, -1.7)], -1),
        np.stack([rng.uniform(-30, 30, 1200),
                  np.where(rng.uniform(size=1200) < 0.5, 11.0, -11.0),
                  rng.uniform(-1.5, 6.0, 1200)], -1)]).astype(np.float32)
    pts = tgt[rng.choice(2000, 256, replace=False)] \
        + 0.05 * rng.normal(size=(256, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, 512)
    R = np.zeros((512, 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    R[:, 1, 0], R[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    R[:, 2, 2] = 1.0
    t = rng.uniform(-5, 5, (512, 3)).astype(np.float32)
    q = torch.einsum("mij,sj->msi", torch.from_numpy(R).to(dev),
                     torch.from_numpy(pts).to(dev)) \
        + torch.from_numpy(t).to(dev)[:, None, :]
    q = q.reshape(-1, 3).contiguous()
    qm = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    p = torch.from_numpy(tgt).to(dev)
    pm = torch.from_numpy(rng.uniform(size=2000) < 0.95).to(dev)
    got, want = kernels.nn(q, qm, p, pm), kernels.nn_plain(q, qm, p, pm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _same_bits(lambda: kernels.nn(q, qm, p, pm))


def _street_scene(seed=91, n_raw=16384):
    """(pose, scan) of a small structured world (ground, a walled street,
    posts): ``pose(x, y, deg)`` a 4x4, ``scan(T)`` a cloud seen from T."""
    rng = np.random.default_rng(seed)
    n = 90000
    g = np.stack([rng.uniform(-45, 45, n // 2), rng.uniform(-45, 45, n // 2),
                  0.03 * rng.normal(size=n // 2) - 1.7], -1)
    side = rng.integers(0, 3, n // 4)
    u = rng.uniform(-45, 45, n // 4)
    w = np.stack([np.where(side == 2, 20.0, u),
                  np.where(side == 0, 9.0, np.where(side == 1, -12.0, u)),
                  rng.uniform(-1.5, 4.0, n // 4)], -1)
    c = rng.uniform(-40, 40, (n // 4 // 60 + 1, 2))
    k = np.repeat(np.arange(len(c)), 60)[:n // 4]
    posts = np.stack([c[k, 0] + 0.02 * rng.normal(size=len(k)),
                      c[k, 1] + 0.02 * rng.normal(size=len(k)),
                      rng.uniform(-1.5, 2.5, len(k))], -1)
    world = np.concatenate([g, w, posts]).astype(np.float32)

    def pose(x, y, deg):
        T = np.eye(4)
        a = np.radians(deg)
        T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        T[:2, 3] = [x, y]
        return T

    def scan(T):
        inv = np.linalg.inv(T)
        loc = (world @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
        sel = np.where(np.linalg.norm(loc[:, :2], axis=1) < 35.0)[0]
        sel = rng.choice(sel, min(len(sel), n_raw), replace=False)
        return {"xyz": loc[sel] + 0.01 * rng.normal(size=(len(sel), 3))
                .astype(np.float32),
                "intensity": np.abs(np.sin(world[sel, 0])).astype(np.float32)
                * 100.0}

    return pose, scan


def _reg_scene(seed=91, n_raw=16384):
    """A target and a source scan 1.55 m / 6 deg apart in the street scene,
    and the truth."""
    pose, scan = _street_scene(seed, n_raw)
    P_t, P_s = pose(0.0, 0.0, 0.0), pose(1.5, 0.4, 6.0)
    return scan(P_t), scan(P_s), np.linalg.inv(P_t) @ P_s


def _small_reg_cfg():
    from mulls_tpu_torch.config import (FeatureConfig, MapConfig,
                                        MapShapeConfig, MullsConfig,
                                        ShapeConfig)
    return MullsConfig(
        shapes=ShapeConfig(n_raw=16384, n_unground=8192, n_ground_full=1024,
                           n_pillar_full=512, n_beam_full=512,
                           n_facade_full=1024, n_roof_full=256,
                           n_vertex_full=512, grid_dim=64),
        feature=FeatureConfig(ground_down_fixed_num=256,
                              pillar_down_fixed_num=128,
                              facade_down_fixed_num=256,
                              beam_down_fixed_num=64, roof_down_fixed_num=64,
                              unground_down_fixed_num=2048,
                              vertex_keep_num=128),
        map=MapConfig(shapes=MapShapeConfig(ground=1024, pillar=256,
                                            beam=256, facade=1024, roof=128,
                                            vertex=256)))


@pytest.mark.parametrize("coarse", ["gnc", "fpfh", "yaw4dof"])
def test_register_pair_on_the_card_agrees_with_the_cpu(dev, coarse):
    """apps/reg.py::register_pair at a small width on the card and on the
    CPU with the same draws: equal process codes, transforms within
    2 cm / 0.2 deg of each other and 0.1 m / 0.5 deg of the truth; the
    fine stage launched nn_grouped, and FPFH-SAC nn."""
    import dataclasses

    from mulls_tpu_torch.apps.reg import register_pair
    tgt, src, T_true = _reg_scene()
    cfg = _small_reg_cfg()
    # the pairwise CLI's own first gate (script/run_mulls_reg.sh,
    # --corr_dis_thre=3.0): the heading sweep starts every seed from zero
    # translation, 1.55 m from the truth, where the default 1.5 m gate
    # finds too few correspondences on the card and on the CPU alike
    cfg = cfg.replace(reg=dataclasses.replace(cfg.reg,
                                              corr_dis_thre_init=3.0))

    def run(where):
        draws = [_HostDraws(s, where) for s in (1, 2, 3)]
        return register_pair(cfg, tgt, src, coarse=coarse, device=where,
                             draws=draws)

    T_cpu, s_cpu = run("cpu")
    with kernels.count_launches() as rec:
        T_card, s_card = run(dev)
    assert s_card["process_code"] == s_cpu["process_code"] == 1
    for T in (T_card, T_cpu):
        assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < 0.1
    assert np.linalg.norm(T_card[:3, 3] - T_cpu[:3, 3]) < 0.02
    M = T_card[:3, :3].T @ T_cpu[:3, :3]
    assert np.degrees(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1))) < 0.2
    assert rec["nn_grouped"] > 0 and rec["pca_moments"] > 0
    assert (rec["nn"] > rec["nn_grouped"]) == (coarse == "fpfh")


# --- multi-sequence odometry, the mesh, sharded PGO, the native reader
# (the CPU parity tests: tests/test_torch_{multiseq,parallel,native_io}.py)

def _drives(n_seq, n_frames, seed=93):
    """``n_seq`` drives of the street scene east at 0.4 m/frame, each from
    its own start, as padded frames of the small width."""
    from mulls_tpu_torch.io.dataset import pad_cloud
    pose, scan = _street_scene(seed)
    return [[pad_cloud(scan(pose(-8.0 + s + 0.4 * k, -1.0 - 0.5 * s, 0.0)),
                       16384)
             for k in range(n_frames)] for s in range(n_seq)]


def test_multiseq_on_the_card_equals_each_run_alone(dev):
    """Three sequences on a one-card mesh, stepped as one batch, the last a
    frame shorter: each equals ``OdometryPipeline`` alone bit for bit,
    registers every frame (host draws: the
    CPU's numbers, on which these drives register), and launched the front
    end's kernels."""
    from mulls_tpu_torch.parallel.mesh import make_mesh
    from mulls_tpu_torch.parallel.multiseq import MultiSeqPipeline
    from mulls_tpu_torch.pipeline.odometry import OdometryPipeline
    cfg = _small_reg_cfg()
    seqs = _drives(3, 6)
    seqs[2] = seqs[2][:5]
    pipe = MultiSeqPipeline(cfg, make_mesh(1), segment=4)
    res = pipe.run(seqs, draws=[_HostDraws(s, dev) for s in range(3)])
    for s, r in enumerate(res):
        alone = OdometryPipeline(pipe.cfg, segment=4, device=dev,
                                 draws=_HostDraws(s, dev)).run(seqs[s])
        assert r.codes == alone.codes and all(c == 1 for c in r.codes)
        np.testing.assert_array_equal(r.poses, alone.poses)
        for name in ("nn_grouped", "moments", "pca_moments"):
            assert pipe.launches[s][name] > 0, (s, name)


def test_make_mesh_lists_the_cards(dev):
    from mulls_tpu_torch.parallel.mesh import make_mesh
    n = torch.cuda.device_count()
    assert make_mesh().devices == tuple(torch.device("cuda", i)
                                        for i in range(n))
    with pytest.raises(ValueError, match="cards"):
        make_mesh(n + 1)


def test_sharded_pgo_on_the_card(dev):
    """The ring of tests/test_multiseq.py on four entries of the card:
    within 1e-3 m of the one-device solver on the card, within 1e-4 of the
    same mesh on the CPU, and the same bits twice."""
    from mulls_tpu_torch.backend.pgo import (optimize_pose_graph,
                                             optimize_pose_graph_sharded)
    from mulls_tpu_torch.parallel.mesh import Mesh
    from mulls_tpu_torch.parallel.ring_check import ring_graph, torch_graph
    g = ring_graph()
    card = Mesh((dev,) * 4)
    t, q, chi2 = optimize_pose_graph_sharded(torch_graph(g, dev), card,
                                             iterations=15)
    t1, _, _ = optimize_pose_graph(torch_graph(g, dev), iterations=15)
    tc, _, _ = optimize_pose_graph_sharded(
        torch_graph(g), Mesh((torch.device("cpu"),) * 4), iterations=15)
    np.testing.assert_allclose(t.cpu().numpy(), t1.cpu().numpy(), atol=1e-3)
    np.testing.assert_allclose(t.cpu().numpy(), tc.numpy(), atol=1e-4)
    assert _same_bits(lambda: optimize_pose_graph_sharded(
        torch_graph(g, dev), card, iterations=15)[0])


def test_native_reader_feeds_the_card_as_the_numpy_reader(dev, tmp_path):
    """Packed segments from the C++ workers, uploaded once a segment, give
    the frames the numpy reader's pack gives."""
    from mulls_tpu_torch.io import native
    from mulls_tpu_torch.io.dataset import FolderDataset
    from mulls_tpu_torch.io.pcd import write_pcd
    from mulls_tpu_torch.pipeline.odometry import prefetch_frames
    assert native.native_available()
    for k, f in enumerate(_drives(1, 5)[0]):
        m = f["mask"]
        write_pcd(str(tmp_path / f"{k:06d}.pcd"), f["xyz"][m],
                  f["intensity"][m] / 255.0)
    got = list(prefetch_frames(FolderDataset(str(tmp_path), 16384), dev,
                               segment=2))
    want = list(prefetch_frames(FolderDataset(str(tmp_path), 16384,
                                              native=False), dev))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.xyz_q.is_cuda
        for name in ("xyz_q", "intensity_q", "ts_q", "n"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
