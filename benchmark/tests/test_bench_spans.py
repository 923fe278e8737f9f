"""The per-layer metrics that read the program's spans and sync counters,
each on a hand-built run whose launch-record snapshots hold known keys:
the expected number, and None without a trace or without the program's
keys (a program that has no spans)."""

import os

import pytest

import benchutil
from benchlib.catalog import Catalog
from benchlib.drive import Record
from benchlib.main import Run

S = 11
KERNELS = {"nn": 0, "nn_grouped": 0, "moments": 0, "pca_moments": 0,
           "count_within": 0}


def _run(traced=True, spans=True):
    """Window frames 32-80, the traced segment 48-64 (0.8 s): 3.2 s of
    step.feature, 6.4 s of step.reg, 0.32 s of step.map, 40 ms of feed.wait,
    0.2 s of sync.eigh and 40 ms of sync.fetch in it; 1,100 syncs in the
    window."""
    rec = Record(S=S, segment=16, seconds=1.0, warm_segments=2)
    rec.start, rec.end = 32, 80
    zero = dict(KERNELS, **{"sync:eigh": 0, "sync:fetch": 0})
    if spans:
        zero.update({f"span:{n}:{u}": 0 for n in (
            "step.feature", "step.reg", "step.map", "feed.wait",
            "sync.eigh", "sync.fetch") for u in ("ns", "n")})
    rec.launches = {32: dict(zero), 48: dict(zero)}
    rec.launches[48]["sync:eigh"] = 320
    after = dict(rec.launches[48])
    after.update({"sync:eigh": 640, "sync:fetch": 1})
    if spans:
        after.update({"span:step.feature:ns": int(3.2e9),
                      "span:step.reg:ns": int(6.4e9),
                      "span:step.map:ns": int(0.32e9),
                      "span:feed.wait:ns": int(0.04e9),
                      "span:sync.eigh:ns": int(0.2e9),
                      "span:sync.fetch:ns": int(0.04e9)})
    rec.launches[64] = after
    rec.launches[80] = dict(after, **{"sync:eigh": 1100 - 3,
                                      "sync:fetch": 3})
    if not spans:  # a program without the counters at all
        rec.launches = {k: dict(KERNELS) for k in rec.launches}
    rec.trace = ({"segment": [48, 64], "window_s": 0.8, "busy_s": 0.2,
                  "device_ops": 0} if traced else None)
    cat = Catalog(benchutil.ROOT)
    readers = {n: cat.reader(n) for n in NAMES}
    return Run(rec, readers, "cpu")


NAMES = ("feature_host_ms_per_seqframe", "reg_host_ms_per_seqframe",
         "map_host_ms_per_seqframe", "host_syncs_per_step",
         "host_sync_wait_pct", "feed_wait_pct")
EXPECTED = (3200.0 / (S * 16), 6400.0 / (S * 16), 320.0 / (S * 16),
            1100 / 48, 100.0 * 0.24 / 0.8, 100.0 * 0.04 / 0.8)


@pytest.mark.parametrize("name,want", list(zip(NAMES, EXPECTED)))
def test_reader_gives_the_expected_number(name, want):
    run = _run()
    assert run.readers[name].read(run) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_none_without_a_trace(name):
    run = _run(traced=False)
    assert run.readers[name].read(run) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_none_without_the_programs_counters(name):
    run = _run(spans=False)
    assert run.readers[name].read(run) is None


def test_every_reader_has_its_benchmark_entry():
    entries = {m["name"]: m for m in Catalog(benchutil.ROOT)
               .bench["per_layer"]}
    for name in NAMES:
        assert name in entries and "workloads" not in entries[name]
        assert entries[name]["moves"] == "seq_frames_per_s"
        assert os.path.exists(os.path.join(benchutil.HERE, "metrics",
                                           name + ".py"))
