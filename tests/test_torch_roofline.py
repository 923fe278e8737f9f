"""Parity of the roofline probe's kernels (mulls_tpu_torch/tools/roofline.py)
with the TPU tool's Pallas variants (tools/perf_mfu_roofline.py).

On the CPU the wrappers take their plain PyTorch versions; those are held
against ``_variant`` with ``_kernel_dist_only`` and ``_kernel_static_f``,
run in Pallas interpret mode.  The tool is loaded from its file and left
as it is: the tests only route its ``pl.pallas_call`` through
``interpret=True``.  The CUDA kernels run only on a card:
tests/test_torch_cuda.py holds them against these plain versions there.

Tolerances: the tool expands d2 = |q|^2 + |p|^2 - 2 q.p and the port forms
((q-p)_x^2 + (q-p)_y^2) + (q-p)_z^2, which differ by ~1e-5 m^2 at these
coordinates, so a pair within 1e-4 m^2 of its r^2 could fall on either
side.  The inputs mark such support points invalid on both sides (a
handful of the 2500), and then counts and sums with an all-ones stack
agree exactly."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mulls_tpu_torch.tools import roofline as rf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tool(monkeypatch):
    """tools/perf_mfu_roofline.py as a module, its Pallas calls run in
    interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "perf_mfu_roofline_under_test",
        os.path.join(REPO, "tools", "perf_mfu_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return mod


def _clouds(seed, qn=300, pn=2500, extent=5.0):
    """~10 neighbours a query in r^2 in [0.5, 1.5]; 10 % invalid support,
    and no valid pair within 1e-4 m^2 of its query's r^2."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-extent, extent, (qn, 3)).astype(np.float32)
    p = rng.uniform(-extent, extent, (pn, 3)).astype(np.float32)
    pm = rng.uniform(size=pn) < 0.9
    r2 = rng.uniform(0.5, 1.5, qn).astype(np.float32)
    d2 = ((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    near = np.any(np.abs(d2 - r2[:, None]) < 1e-4, axis=0)
    return q, p, pm & ~near, r2


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _numpy_adjacency(q, p, pm, r2):
    """The port's distance in numpy float32, op by op."""
    d = q[:, None, :] - p[None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return pm[None, :] & (d2 <= r2[:, None])


def test_count_within_plain_matches_dist_only_variant(tool):
    q, p, pm, r2 = _clouds(0)
    out = np.asarray(tool._variant(tool._kernel_dist_only, False, q, p, pm,
                                   r2))
    got = rf.count_within(*_t(q, p, pm, r2))
    assert got.dtype == torch.float32 and got.shape == (300,)
    # the tool writes the count to column 0 of a padded [Qp, 128] block;
    # the other columns and the padded rows (r^2 = 0) stay 0
    assert out.shape[0] >= 300 and np.all(out[:, 1:] == 0)
    np.testing.assert_array_equal(got.numpy(), out[:300, 0])
    np.testing.assert_array_equal(
        got.numpy(), _numpy_adjacency(q, p, pm, r2).sum(1))
    assert 5 < got.mean() < 20  # neighbourhoods, not empty rows


def test_adj_stack_plain_matches_static_stack_variant(tool):
    q, p, pm, r2 = _clouds(1)
    out = np.asarray(tool._variant(tool._kernel_static_f, True, q, p, pm, r2))
    ones = torch.ones((2500, 128), dtype=torch.bfloat16)
    got = rf.adj_stack(*_t(q, p, pm, r2), ones)
    assert got.dtype == torch.float32 and got.shape == (300, 128)
    # F is all ones in the tool: every column is the count, exactly
    np.testing.assert_array_equal(got.numpy(), out[:300])
    np.testing.assert_array_equal(
        got.numpy()[:, 0], rf.count_within(*_t(q, p, pm, r2)).numpy())


@pytest.mark.parametrize("c", [16, 48, 128])
def test_adj_stack_plain_with_random_bf16_stack(c):
    q, p, pm, r2 = _clouds(2 + c)
    rng = np.random.default_rng(c)
    f = torch.from_numpy(rng.normal(size=(2500, c)).astype(np.float32)).to(
        torch.bfloat16)
    got = rf.adj_stack(*_t(q, p, pm, r2), f).numpy().astype(np.float64)
    adj = _numpy_adjacency(q, p, pm, r2).astype(np.float64)
    f64 = f.to(torch.float64).numpy()
    want = adj @ f64
    # fp32 sums of ~10 terms against float64: the tolerance of the card's
    # check, rtol 1e-5 and atol 1e-5 times the sum of |terms|
    assert np.all(np.abs(got - want)
                  <= 1e-5 * np.abs(want) + 1e-5 * (adj @ np.abs(f64)))
    # integer-valued, column-distinct stack (|values| <= 256, exact in
    # bf16): exact sums (a transposed fragment on the card would show here)
    ints = torch.arange(1, c + 1, dtype=torch.float32)[None, :] * \
        torch.from_numpy(rng.integers(-2, 3, (2500, 1)).astype(np.float32))
    got = rf.adj_stack(*_t(q, p, pm, r2), ints.to(torch.bfloat16))
    np.testing.assert_array_equal(got.numpy(), adj @ ints.double().numpy())


def test_wrappers_take_plain_path_on_cpu_and_count_nothing():
    q, p, pm, r2 = _t(*_clouds(3, qn=40, pn=200))
    rf.reset_launch_counts()
    assert torch.equal(rf.count_within(q, p, pm, r2),
                       rf.count_within_plain(q, p, pm, r2))
    f = torch.ones((200, 16), dtype=torch.bfloat16)
    assert torch.equal(rf.adj_stack(q, p, pm, r2, f),
                       rf.adj_stack_plain(q, p, pm, r2, f))
    assert rf.launch_counts() == {"count_within": 0, "adj_stack": 0}
    # no queries: empty results
    assert rf.count_within(q[:0], p, pm, r2[:0]).shape == (0,)
    assert rf.adj_stack(q[:0], p, pm, r2[:0], f).shape == (0, 16)


@pytest.mark.parametrize("bad", ["dtype", "stack_dtype", "width", "wide",
                                 "shape", "device"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    q, p, pm, r2 = _t(*_clouds(4, qn=20, pn=50))
    f = torch.ones((50, 16), dtype=torch.bfloat16)
    if bad == "dtype":
        q = q.double()
    elif bad == "stack_dtype":
        f = f.float()
    elif bad == "width":
        f = torch.ones((50, 24), dtype=torch.bfloat16)
    elif bad == "wide":
        f = torch.ones((50, 144), dtype=torch.bfloat16)
    elif bad == "shape":
        r2 = r2[:10]
    else:  # neither CPU nor CUDA: no kernel and no plain path
        q, p, pm, r2, f = (x.to("meta") for x in (q, p, pm, r2, f))
    with pytest.raises((TypeError, ValueError)):
        rf.adj_stack(q, p, pm, r2, f)
    if bad in ("dtype", "shape", "device"):
        with pytest.raises((TypeError, ValueError)):
            rf.count_within(q, p, pm, r2)


def test_probe_rows_on_cpu_at_small_shapes(capsys):
    x = rf.probe_inputs(matmul_n=64, icp_q=50, n=400, moments_q=100,
                        moments_p=200, moments_c=8)
    # the tool's draws, in its order
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(x["a"], rng.normal(size=(64, 64)))
    rng.normal(size=(64, 64))
    np.testing.assert_array_equal(
        x["q_icp"], rng.uniform(-40, 40, (50, 3)).astype(np.float32))
    rf.reset_launch_counts()
    rec = rf.run_probe("cpu", x)
    names = [r["kernel"] for r in rec["rows"]]
    assert names == ["matmul bf16", "matmul fp32", "nn", "nn", "pca_moments",
                     "count_within", "adj_stack", "moments"]
    printed = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in printed] == [n.split()[0] for n in names]
    assert rec["device"] == "cpu" and rec["reps"] == rf.REPS
    for r in rec["rows"]:
        # a CPU run has no device time: the host clock only
        assert r["device_ms"] is None and r["event_ms"] is None
        assert r["host_ms"] > 0 and r["gflop"] > 0
        assert r["bound_by"] in ("bytes", "operations")
        assert r["bound_ms"] > 0 and r["achieved_tflops"] > 0
        assert r["share_of_measured_peak"] > 0
    rows = {r["kernel"]: r for r in rec["rows"]}
    pairs = 400 * 400
    cw = rows["count_within"]
    # a cell-grid count: bounded by the bytes and 10 operations a hit; the
    # candidate pairs of the 27 cells around a query, the walk's own work,
    # are kept beside it
    q, p = torch.from_numpy(x["q_map"]), torch.from_numpy(x["p"])
    pm, r2 = torch.ones(400, dtype=torch.bool), torch.ones(400)
    hits = float(rf.count_within_plain(q, p, pm, r2).sum())
    cand = rf.kernels.candidate_pairs(q, p, pm, r2)
    assert 0 < hits <= cand <= pairs
    assert cw["candidate_pairs"] == cand and cw["call_device_ms"] is None
    assert cw["gflop"] == pytest.approx(10.0 * hits / 1e9)
    assert cw["bound_ms"] == pytest.approx(max(
        10.0 * hits / rf.PEAK_FP32_FLOPS,
        (16 * 400 + 13 * 400 + 4 * 400) / rf.PEAK_BYTES_PER_S) * 1e3)
    adj = rows["adj_stack"]
    assert adj["precision"] == "bf16"
    c = rf.STACK_C
    assert adj["gflop"] == pytest.approx(2.0 * c * pairs / 1e9)
    nbytes = 16 * 400 + 13 * 400 + 2 * 400 * c + 4 * 400 * c
    assert adj["tensor_floor_ms"] == pytest.approx(max(
        2.0 * c * pairs / rf.PEAK_BF16_FLOPS,
        nbytes / rf.PEAK_BYTES_PER_S) * 1e3)
    # the function's least work: the distance a pair and C adds a hit
    assert adj["bound_ms"] >= cw["bound_ms"]
    assert rec["measured_peak_bf16_tflops"] > 0
    assert rf.launch_counts() == {"count_within": 0, "adj_stack": 0}


def test_probe_entry_point_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rf.main(["--out", str(tmp_path / "probe.json")])
    assert not (tmp_path / "probe.json").exists()
