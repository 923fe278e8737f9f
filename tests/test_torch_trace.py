"""The port's counters, spans and host syncs by site (``core/trace.py``)
on the CPU: spans off are one shared no-op and leave no key; records nest;
a small ``MultiSeqPipeline`` run under ``torch.profiler`` carries the
step's spans as user annotations around its operators, with the same
times in the record; the sync sites a batched frame do not depend on the
batch; the timing report's clock and the fleet CLI's ``--profile_dir``.

The width is below the parity tests' (a few seconds a run), one torch
thread, no scan-to-scan warm-up, so every segment after the first is
steady."""

import inspect
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mulls_tpu_torch.config import (FeatureConfig, MapConfig, MapShapeConfig,
                                    MullsConfig, RegConfig, ShapeConfig)
from mulls_tpu_torch.core import trace
from mulls_tpu_torch.ops import kernels
from mulls_tpu_torch.parallel.mesh import make_mesh
from mulls_tpu_torch.parallel.multiseq import MultiSeqPipeline
from mulls_tpu_torch.pipeline import odometry
from test_pipeline import _ListDataset, _loop_world, _simulate_scan

ITERS = 5  # scan-to-map ICP iterations
SEGMENT = 2
FRAMES = 4
STAGES = ("step.feature", "step.reg", "step.map")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return MullsConfig(
        shapes=ShapeConfig(n_raw=8192, n_unground=4096, n_ground_full=1024,
                           n_pillar_full=256, n_beam_full=256,
                           n_facade_full=512, n_roof_full=128,
                           n_vertex_full=256, grid_dim=64),
        feature=FeatureConfig(ground_down_fixed_num=256,
                              pillar_down_fixed_num=64,
                              facade_down_fixed_num=128,
                              beam_down_fixed_num=32, roof_down_fixed_num=32,
                              unground_down_fixed_num=1024,
                              vertex_keep_num=64),
        reg=RegConfig(reg_max_iter_num_s2m=ITERS),
        map=MapConfig(shapes=MapShapeConfig(ground=1024, pillar=128,
                                            beam=128, facade=512, roof=64,
                                            vertex=128),
                      initial_scan2scan_frame_num=0))


def _sequences(cfg, S, n=FRAMES):
    rng = np.random.default_rng(31)
    world = _loop_world(rng, n=30000, extent=35.0)
    out = []
    for s in range(S):
        ang = 2 * np.pi * s / S + 0.4
        d = np.array([np.cos(ang), np.sin(ang), 0.0])
        poses = []
        for k in range(n):
            T = np.eye(4)
            T[:3, 3] = 0.5 * k * d
            poses.append(T)
        out.append(_ListDataset(
            _simulate_scan(world, T, cfg.shapes.n_raw, 30.0, rng)
            for T in poses))
    return out


def _run(S, on_segment=None):
    """A ``MultiSeqPipeline`` run of S sequences inside an outer launch
    record: (pipe, the record)."""
    cfg = _cfg()
    pipe = MultiSeqPipeline(cfg, make_mesh(1, device="cpu"), segment=SEGMENT)
    with kernels.count_launches() as rec:
        pipe.run(_sequences(cfg, S), on_segment=on_segment)
    return pipe, rec


@pytest.fixture(scope="module")
def profiled():
    """S = 2 under ``torch.profiler`` (CPU): (pipe, record, events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe, rec = _run(2)
    return pipe, rec, list(prof.profiler.kineto_results.events())


# --- the record and the spans ---------------------------------------------

def test_spans_off_are_one_noop_and_leave_no_span_key():
    assert not torch.autograd._profiler_enabled()
    assert trace.span("a") is trace.span("b") is trace.span("c")
    with kernels.count_launches() as rec:
        with trace.span("step"), trace.sync("site"):
            pass
        with trace.span("timed", timed=True) as sp:
            sum(range(1000))
    assert sp.ns > 0 and sp.ms == sp.ns / 1e6
    assert rec == {"nn": 0, "nn_grouped": 0, "moments": 0,
                   "pca_moments": 0, "count_within": 0, "sync:site": 1}


def test_enabled_spans_nest_into_the_outer_record():
    with kernels.count_launches() as outer, trace.enabled():
        with trace.record() as inner, trace.span("parent"):
            for _ in range(3):
                with trace.span("child"), trace.sync("wait"):
                    kernels._count(kernels.nn)
        assert inner["span:child:n"] == 3 and inner["nn"] == 3
        assert inner["span:sync.wait:n"] == inner["sync:wait"] == 3
    assert not trace._enabled
    for key, k in inner.items():
        assert outer[key] == k, key
    assert outer["span:parent:n"] == 1
    assert outer["span:child:ns"] <= outer["span:parent:ns"]
    assert trace.totals(["sync:wait"])["sync:wait"] >= 3


def test_stage_clock_laps_are_the_stage_spans():
    with trace.StageClock("cpu", STAGES) as clock:
        for name in STAGES[::-1]:
            with trace.span(name):
                sum(range(20000))
        laps = clock.lap()
        assert clock.lap() == [0.0, 0.0, 0.0]
    assert all(ms > 0 for ms in laps)
    assert trace.span("x") is trace.span("y")  # off again
    assert "timer" not in inspect.signature(odometry.slam_step).parameters


# --- the fleet step under the profiler --------------------------------------

# the stage-level spans (milliseconds and more a span at this width) and
# the small ones around one wait or one copy
STAGE_SPANS = ("segment", "step", "step.feature", "step.reg", "step.map",
               "reg.iter", "feature.pca", "map.insert")
SMALL_SPANS = ("step.stack", "feed.wait", "segment.fetch", "sync.eigh",
               "sync.fetch")


@pytest.mark.parametrize("name", STAGE_SPANS + SMALL_SPANS)
def test_profiled_spans_match_the_record(profiled, name):
    """Each span is a host event on the profiler's clock, as often as the
    record counts it (a range of function scope: not a user annotation,
    which the profiler would mirror onto the device's timeline), and its
    clock lies inside its event: the record's total is at most the
    events'.  A stage-level span's total is the events' within 5 % (a
    small span's event is mostly the range's own entry and exit), and each
    of its events encloses operators."""
    _, rec, events = profiled
    mine = [e for e in events if e.name() == name]
    assert not any(e.is_user_annotation() for e in mine)
    assert len(mine) == rec[f"span:{name}:n"] > 0
    total = sum(e.duration_ns() for e in mine)
    assert rec[f"span:{name}:ns"] <= total
    if name in STAGE_SPANS:
        assert rec[f"span:{name}:ns"] >= 0.95 * total
        ops = [e for e in events if e.name().startswith("aten::")]
        for e in mine:
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            assert any(a <= o.start_ns() and o.start_ns() + o.duration_ns()
                       <= b for o in ops), name


def test_profiled_children_sum_to_at_most_their_parent(profiled):
    pipe, rec, _ = profiled

    def ns(*names):
        return sum(rec[f"span:{n}:ns"] for n in names)

    assert ns(*STAGES) <= ns("step")
    assert ns("reg.iter", "reg.pose") <= ns("step.reg")
    assert ns("feature.ground", "feature.pca", "feature.classify",
              "feature.down") <= ns("step.feature")
    assert ns("map.undistort", "map.insert") <= ns("step.map")
    assert ns("step", "step.stack", "feed.wait", "segment.fetch") \
        <= ns("segment")
    assert rec["span:segment:n"] == FRAMES // SEGMENT
    assert rec["span:step:n"] == FRAMES
    # the pipeline's own records keep the kernels' keys alone
    assert set(pipe.launches[0]) == set(pipe.block_launches[0]) \
        == set(kernels.LAUNCH_KEYS)


@pytest.mark.parametrize("S", [1, 3, 3])
def test_syncs_a_batched_frame_do_not_depend_on_the_batch(S):
    """Spans off: the sync counters still count.  A steady batched frame
    waits at ``eigh`` once an ICP iteration and twice at each of its two
    ``svd`` calls (the ICP's rotation and the pose), and the segment once
    at its copy, whatever S, in every run."""
    _, rec = _run(S)
    syncs = {k: v for k, v in rec.items() if k.startswith("sync:")}
    assert syncs == {"sync:eigh": ITERS * FRAMES, "sync:svd": 4 * FRAMES,
                     "sync:fetch": FRAMES // SEGMENT}
    assert not any(k.startswith("span:") for k in rec)


def test_fleet_cli_profiles_one_steady_segment(tmp_path, monkeypatch):
    """``--profile_dir``: a Chrome trace of one segment after the warm-up,
    with the step's spans in it and the feeds' workers' (their own
    threads); the run's outputs as without it."""
    import mulls_tpu_torch.config as tconfig
    from mulls_tpu_torch.apps import slam_multiseq as cli

    cfg = _cfg()
    folders = []
    # more frames than the feeds queue ahead (4), so that their workers
    # still read while the second frame steps
    for s, seq in enumerate(_sequences(cfg, 2, n=7)):
        d = tmp_path / f"seq{s}"
        d.mkdir()
        for k, f in enumerate(seq):
            m = f["mask"]
            np.concatenate([f["xyz"][m], f["intensity"][m, None] / 255.0],
                           1).astype(np.float32).tofile(d / f"{k:06d}.bin")
        folders.append(str(d))
    monkeypatch.setattr(tconfig, "MullsConfig", lambda: cfg)
    assert cli.main(["--sequence_folders", ",".join(folders), "--segment",
                     "1", "--device", "cpu", "--output_dir",
                     str(tmp_path / "out"), "--profile_dir",
                     str(tmp_path / "prof")]) == 0
    assert sorted(os.listdir(tmp_path / "out")) == [
        "seq0_pose.txt", "seq1_pose.txt", "summary.json"]
    with open(tmp_path / "prof" / "trace.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("segment") == 1
    for name in STAGES + ("step", "reg.iter", "sync.eigh", "feed.read"):
        assert name in names, name
    assert not trace._enabled
