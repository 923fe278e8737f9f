"""The harness finds everything by name, a cell is added by files and
entries alone, and a run's last line holds the contract's keys, with the
numbers compared last.  CPU, the tiny cell (two sequences at the parity
tests' small width, segments of four frames)."""

import json
import os
import re
import shutil

import pytest
import torch

import benchutil
from benchlib import check
from benchlib.catalog import Catalog, apply_overrides

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bench():
    with open(os.path.join(benchutil.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_the_contracts_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200


def test_the_catalog_finds_every_piece_by_name():
    cat = Catalog(benchutil.ROOT)
    from mulls_tpu_torch.config import MullsConfig
    for w in cat.bench["workloads"]:
        config = cat.config(w["config"])
        cfg = apply_overrides(MullsConfig(), config["mulls_config"])
        assert cfg.shapes.n_raw == 131072 and cfg.shapes.n_unground == 20480
        mix = cat.traffic(w["traffic"])
        assert mix["name"] == w["traffic"]
        for name in config["sequences"]:
            assert mix.get("sequence_world", {}).get(
                name, mix["default_world"]) in mix["worlds"]
        limits = cat.limits(w["config"])
        assert {"feat_match_m", "map_match_m"} <= set(limits)
        assert set(check.compared(limits)) >= {"nn_miss", "feat_miss"}
        readers = cat.readers(w["name"])
        assert set(readers) == {m["name"] for m in cat.bench["per_layer"]}
        assert all(callable(r.read) for r in readers.values())


def test_a_mix_added_from_a_temporary_directory_runs(tmp_path, capsys):
    root, here = benchutil.tiny_root(tmp_path)
    # a new mix: the tiny one on the highway world alone, added as a file
    with open(os.path.join(here, "traffic", "tiny_mix.json")) as f:
        mix = json.load(f)
    mix.update(name="tiny_highway", default_world="highway",
               sequence_world={})
    with open(os.path.join(here, "traffic", "tiny_highway.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny_fleet.tiny_highway",
                               "config": "tiny_fleet",
                               "traffic": "tiny_highway", "chips": 1,
                               "why": "a mix added by a file"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    assert Catalog(root, here).traffic("tiny_highway")["name"] == \
        "tiny_highway"
    import time

    from benchlib.main import main
    assert main(["--workload", "tiny_fleet.tiny_highway", "--seed", "4",
                 "--seconds", "0.01", "--trace", "0"], root,
                time.perf_counter(), require_card=False, device="cpu",
                here=here) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True


def test_the_last_line_holds_the_contracts_keys_and_the_checks_last(
        tmp_path, capsys):
    root, here = benchutil.tiny_root(tmp_path)
    res = benchutil.run_tiny(root, here, 2**31 + 77, capsys=capsys)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"seq_frames_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert res["metrics"]["seq_frames_per_s"]["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["attempted"] == 2 * 4 and res["correct"] is True
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


def test_no_card_no_result(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import time

    from benchlib.main import main
    root, here = benchutil.tiny_root(tmp_path)
    assert main(["--workload", benchutil.TINY_CELL, "--seed", "1",
                 "--seconds", "1", "--trace", "0"], root,
                time.perf_counter(), here=here) != 0
    assert capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    import subprocess
    import sys
    shutil.copytree(benchutil.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(benchutil.ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "kitti_fleet11.kitti_mix", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
