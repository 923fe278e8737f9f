"""Helpers of the benchmark's tests: a benchmark root in a temporary
directory with the tiny CPU cell, and a run of the harness on it."""

import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = os.path.join(HERE, "tests", "data")
TINY_CELL = "tiny_fleet.tiny_mix"


def tiny_root(tmp) -> tuple:
    """(root, here): a BENCHMARK.json naming the tiny cell under ``root``,
    and a copy of the harness's mixes, limits and metrics under ``here``
    with the tiny mix added."""
    root = os.path.join(str(tmp), "root")
    here = os.path.join(root, "bench")
    for sub in ("traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(here, sub))
    shutil.copy(os.path.join(DATA, "tiny_mix.json"),
                os.path.join(here, "traffic", "tiny_mix.json"))
    shutil.copy(os.path.join(DATA, "tiny_fleet.json"),
                os.path.join(root, "tiny_fleet.json"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny_fleet", "source": "tests",
                         "file": "tiny_fleet.json", "reduced": [],
                         "why": "the tests' tiny cell"}]
    bench["workloads"] = [{"name": TINY_CELL, "config": "tiny_fleet",
                           "traffic": "tiny_mix", "chips": 1,
                           "why": "the tests' tiny cell"}]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root, here


def run_tiny(root, here, seed, trace=0, capsys=None) -> dict:
    """One CPU run of the tiny cell; its result line, parsed."""
    from benchlib.main import main
    rc = main(["--workload", TINY_CELL, "--seed", str(seed), "--seconds",
               "0.01", "--trace", str(trace)], root, time.perf_counter(),
              require_card=False, device="cpu", here=here)
    assert rc == 0, rc
    out = capsys.readouterr().out if capsys is not None else None
    return json.loads(out.strip().splitlines()[-1]) if out else None
