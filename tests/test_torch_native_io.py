"""The port's native C++ reader (``mulls_tpu_torch/io/native.py``, built
here with ``g++`` from the port's own copy of the source) against the
port's numpy readers and the reference's native reader, on the formats
and cases of tests/test_native_io.py: pcd (binary and ascii), KITTI bin
and txt, the over-capacity subsample and its seed, the prefetcher's
order, packed segments against ``pack_raw_host``; then
``OdometryPipeline`` over a native ``FolderDataset`` against the same run
on the numpy readers, bit for bit.

The reference's two readers differ on KITTI .bin intensity: its numpy
reader scales it by 255 (``io/kitti.py::read_kitti_bin``), its native one
keeps the file's value.  The port's native reader scales it as the numpy
readers of both packages do, so the port's two readers give the same
clouds: there it equals the reference's native reader times 255."""

import os

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from mulls_tpu.io import native as jnio
from mulls_tpu_torch.core.cloud import pack_raw_host
from mulls_tpu_torch.io import native as tnio
from mulls_tpu_torch.io.dataset import (FolderDataset, pad_cloud,
                                        read_point_cloud)
from mulls_tpu_torch.io.pcd import write_pcd
from mulls_tpu_torch.pipeline.odometry import OdometryPipeline

N_RAW = 1024


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Five clouds of 600-900 points in every format the CLI reads most
    (bin, binary pcd, ascii pcd, txt), and one of 3000 points (over
    ``N_RAW``)."""
    d = tmp_path_factory.mktemp("clouds")
    rng = np.random.default_rng(21)
    for k in range(5):
        pts = rng.uniform(-30, 30, (600 + 75 * k, 4)).astype(np.float32)
        pts[:, 3] = rng.uniform(0, 1, len(pts))
        pts.tofile(d / f"{k:06d}.bin")
        write_pcd(str(d / f"b{k}.pcd"), pts[:, :3], pts[:, 3])
        write_pcd(str(d / f"a{k}.pcd"), pts[:, :3], pts[:, 3], binary=False)
        np.savetxt(d / f"{k:06d}.txt", pts, fmt="%.6f")
    big = rng.uniform(-30, 30, (3000, 4)).astype(np.float32)
    os.makedirs(d / "big")
    big.tofile(d / "big" / "000000.bin")
    return d


def test_the_library_builds_under_build_and_loads():
    info = tnio.build_library()
    assert os.path.exists(info["path"])
    assert f"{os.sep}build{os.sep}mulls_tpu_torch_native{os.sep}" \
        in info["path"]
    assert tnio.native_available()


@pytest.mark.parametrize("name", ["000002.bin", "b2.pcd", "a2.pcd",
                                  "000002.txt"])
def test_native_read_equals_numpy_and_reference(folder, name):
    path = str(folder / name)
    port = tnio.read_cloud_native(path, N_RAW)
    ref = jnio.read_cloud_native(path, N_RAW)
    numpy_ = pad_cloud(read_point_cloud(path), N_RAW)
    assert set(port) == set(ref) == set(numpy_)
    if name.endswith(".bin"):  # the reference's native x1 (see above)
        ref["intensity"] = ref["intensity"] * np.float32(255)
    for k in port:
        np.testing.assert_array_equal(port[k], ref[k])
        assert port[k].dtype == numpy_[k].dtype
    np.testing.assert_array_equal(port["mask"], numpy_["mask"])
    np.testing.assert_array_equal(port["ts_ratio"], numpy_["ts_ratio"])
    # text is parsed by strtof in C++ and through float64 by numpy
    atol = 0.0 if name.endswith(".bin") or name.startswith("b") else 1e-6
    for k in ("xyz", "intensity"):
        np.testing.assert_allclose(port[k], numpy_[k], atol=atol, rtol=0)


@pytest.mark.parametrize("seed", [0, 5])
def test_over_capacity_subsample_equals_reference(folder, seed):
    path = str(folder / "big" / "000000.bin")
    port = tnio.read_cloud_native(path, N_RAW, seed=seed)
    ref = jnio.read_cloud_native(path, N_RAW, seed=seed)
    ref["intensity"] = ref["intensity"] * np.float32(255)
    for k in port:
        np.testing.assert_array_equal(port[k], ref[k])
    assert port["mask"].sum() == N_RAW
    pts = np.fromfile(path, np.float32).reshape(-1, 4)
    d = np.abs(port["xyz"][:, None, :] - pts[None, :, :3]).sum(-1).min(1)
    assert d.max() == 0.0
    assert np.all(np.diff(port["ts_ratio"]) > 0)
    other = tnio.read_cloud_native(path, N_RAW, seed=seed + 1)
    assert not np.array_equal(other["xyz"], port["xyz"])


def test_prefetcher_order_equals_single_reads_and_reference(folder):
    files = sorted(str(folder / f) for f in os.listdir(folder)
                   if f.endswith(".bin")) + [str(folder / "big" /
                                                 "000000.bin")]
    singles = [tnio.read_cloud_native(f, N_RAW) for f in files[:-1]]
    with tnio.NativePrefetcher(files, N_RAW, workers=3, depth=2) as pf:
        got = list(pf)
    with jnio.NativePrefetcher(files, N_RAW, workers=2, depth=3) as pf:
        ref = list(pf)
    assert len(got) == len(ref) == len(files)
    for a, b in zip(singles, got):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(got, ref):  # the over-capacity frame too
        b["intensity"] = b["intensity"] * np.float32(255)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_packed_segments_equal_pack_raw_host_and_reference(folder):
    files = sorted(str(folder / f) for f in os.listdir(folder)
                   if f.startswith("b") and f.endswith(".pcd"))
    with tnio.PackedSegmentPrefetcher(files, N_RAW, segment=2) as pf:
        got = list(pf)
    with jnio.PackedSegmentPrefetcher(files, N_RAW, segment=2) as pf:
        ref = list(pf)
    assert [k for k, _ in got] == [k for k, _ in ref] == [2, 2, 1]
    for (_, a), (_, b) in zip(got, ref):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for i, f in enumerate(files):
        k, b = got[i // 2]
        want = pack_raw_host(pad_cloud(read_point_cloud(f), N_RAW))
        np.testing.assert_array_equal(b["xyz_q"][i % 2], want.xyz_q.numpy())
        np.testing.assert_array_equal(b["intensity_q"][i % 2],
                                      want.intensity_q.numpy())
        np.testing.assert_array_equal(b["ts_q"][i % 2].astype(np.int32),
                                      want.ts_q.numpy())
        assert int(b["n"][i % 2]) == int(want.n)
    _, tail = got[2]  # the tail batch repeats its last frame
    np.testing.assert_array_equal(tail["xyz_q"][0], tail["xyz_q"][1])


def test_folder_dataset_native_iteration_equals_numpy(folder):
    nat = FolderDataset(str(folder), N_RAW, ext=".pcd")
    num = FolderDataset(str(folder), N_RAW, ext=".pcd", native=False)
    assert nat._native and not num._native
    assert nat.packed_segments(4) is not None
    assert num.packed_segments(4) is None
    got, want = list(nat), list(num)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["mask"], b["mask"])
        np.testing.assert_allclose(a["xyz"], b["xyz"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(nat[3]["xyz"], got[3]["xyz"])


def test_odometry_on_the_native_reader_equals_the_numpy_reader(tmp_path):
    """The packed segments go straight into ``PackedRawCloud``: the run
    equals the run on the numpy readers bit for bit."""
    cfg = ge._small_cfg()
    rng = np.random.default_rng(3)
    world = ge._make_world(3)
    for k in range(4):
        T = np.eye(4)
        T[:3, 3] = [0.6 * k, 0.0, 0.0]
        d = ge._render_scan(world, T, cfg, rng)
        m = d["mask"]
        write_pcd(str(tmp_path / f"{k:06d}.pcd"), d["xyz"][m],
                  d["intensity"][m] / 255.0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = [OdometryPipeline(cfg, segment=3, device="cpu").run(
            FolderDataset(str(tmp_path), cfg.shapes.n_raw, native=native))
            for native in (True, False)]
    finally:
        torch.set_num_threads(n)
    assert runs[0].codes == runs[1].codes
    assert all(c == 1 for c in runs[0].codes[1:])
    np.testing.assert_array_equal(runs[0].poses, runs[1].poses)
