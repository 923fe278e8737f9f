"""The port's host-only modules against the JAX package's: ``core/nav.py``
and ``core/geo.py`` (numpy copies; equal to the reference exactly on the
vectors of tests/test_semantic.py and tests/test_geo_viz.py), and the
``format_transform`` CLI, whose files must equal the reference CLI's byte
for byte."""

import numpy as np
import pytest

from mulls_tpu.apps import format_transform as j_ft
from mulls_tpu.core import geo as j_geo
from mulls_tpu.core import nav as j_nav
from mulls_tpu_torch.apps import format_transform as t_ft
from mulls_tpu_torch.core import geo as t_geo
from mulls_tpu_torch.core import nav as t_nav


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def _moving():
    T = np.eye(4)
    T[2, 3] = 0.01
    T[0, 3] = 1.0
    return T


def _still():
    T = np.eye(4)
    T[2, 3] = 0.01
    return T


def _drive():
    poses = np.tile(np.eye(4), (30, 1, 1))
    poses[:, 0, 3] = np.arange(30) * 0.5
    return poses


# the cases of tests/test_semantic.py::test_nav_helpers
NAV_CASES = [
    ("zupt_treatment", lambda: (_still(),), {"tran_thre": 0.02}),
    ("zupt_treatment", lambda: (_moving(),), {"tran_thre": 0.02}),
    ("estimate_velocity", lambda: (_drive(), 29), {}),
    ("tran_rot_magnitude", lambda: (_moving(),), {}),
]


@pytest.mark.parametrize("name,args,kw", NAV_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(NAV_CASES)])
def test_nav_equals_reference(name, args, kw):
    _same(getattr(t_nav, name)(*args(), **kw),
          getattr(j_nav, name)(*args(), **kw))


# the vectors of tests/test_geo_viz.py:13-66
GEO_CASES = [
    ("blh2xyz", (39.608611, 115.892456, 108.0420), {}),
    ("blh2xyz", (4.640045, -74.080950, 2563.1791), {}),
    ("xyz2blh", tuple(j_geo.blh2xyz(39.608611, 115.892456, 108.0420)), {}),
    ("xyz2neu", (-2148747.998, 4426652.444, 4044675.151, -2148745.727,
                 4426649.545, 4044668.469), {}),
    ("utm_forward", (48.8566, 2.3522), {}),
    ("utm_forward", (31.23, 121.47), {}),
    ("utm_forward", (-33.86, 151.21), {}),
    ("utm_forward", (70.1, -150.2), {}),
    ("utm_forward", (45.0, 123.0), {"zone": 51}),
    ("utm_inverse", tuple(j_geo.utm_forward(31.23, 121.47)), {}),
    ("utm_inverse", tuple(j_geo.utm_forward(-33.86, 151.21)),
     {"south": True}),
    ("utm_inverse", tuple(j_geo.utm_forward(70.1, -150.2)), {}),
    ("gnss_to_pose", (31.23, 121.47, 15.0, 0.0, 0.0, 90.0), {}),
]


@pytest.mark.parametrize("name,args,kw", GEO_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(GEO_CASES)])
def test_geo_equals_reference(name, args, kw):
    _same(getattr(t_geo, name)(*args, **kw), getattr(j_geo, name)(*args, **kw))


def test_geo_round_trips_as_the_reference_tests_do():
    x, y, z = t_geo.blh2xyz(39.608611, 115.892456, 108.0420)
    assert (round(float(x)), round(float(y)), round(float(z))) == \
        (-2148748, 4426656, 4044670)
    lat, lon, h = t_geo.xyz2blh(x, y, z)
    assert abs(float(lat) - 39.608611) < 1e-9
    assert abs(float(h) - 108.0420) < 1e-5
    E, N, zone = t_geo.utm_forward(48.8566, 2.3522)
    assert zone == 31 and abs(float(E) - 452482.5) < 2.0


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ft_in")
    rng = np.random.default_rng(11)
    for k in range(3):
        pts = rng.uniform(-40, 40, (700 + 50 * k, 4)).astype(np.float32)
        pts[:, 3] = rng.uniform(0, 1, len(pts))
        pts.tofile(d / f"{k:06d}.bin")
        np.savetxt(d / f"{k:06d}.txt", pts, fmt="%.6f")
    labels = rng.integers(0, 1 << 20, 700).astype(np.uint32)
    labels.tofile(d / "000000.label")
    return d


@pytest.mark.parametrize("mode", ["bin2pcd", "txt2pcd", "labelbin2pcd",
                                  "folder-bin2pcd", "folder-txt2pcd"])
def test_format_transform_files_equal_the_reference_cli(inputs, tmp_path,
                                                         mode):
    outs = {}
    for tag, mod in (("port", t_ft), ("ref", j_ft)):
        out = tmp_path / tag
        out.mkdir()
        if mode.startswith("folder"):
            argv = ["folder", "--mode", mode.split("-")[1], str(inputs),
                    str(out / "dir")]
        elif mode == "labelbin2pcd":
            argv = [mode, str(inputs / "000000.bin"),
                    str(inputs / "000000.label"), str(out / "a.pcd")]
        else:
            src = inputs / ("000001.bin" if mode == "bin2pcd"
                            else "000001.txt")
            argv = [mode, str(src), str(out / "a.pcd")]
        assert mod.main(argv) == 0
        outs[tag] = {p.relative_to(out): p.read_bytes()
                     for p in sorted(out.rglob("*.pcd"))}
    assert outs["port"] and outs["port"].keys() == outs["ref"].keys()
    for name, data in outs["port"].items():
        assert data == outs["ref"][name], name
