"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (``mulls_tpu_torch`` is not ``mulls_tpu``), and the
plain reference loads nothing of the program."""

import os
import subprocess
import sys
import types

import benchutil
from benchlib.main import forbidden_modules


def _python(code: str, cwd: str = benchutil.ROOT) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_whole_top_level_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "mulls_tpu_torch_extra",
                        types.ModuleType("mulls_tpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("jaxlike"))
    assert "mulls_tpu_torch_extra" not in forbidden_modules()
    assert "jaxlike" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "mulls_tpu.ops",
                        types.ModuleType("mulls_tpu.ops"))
    assert "mulls_tpu.ops" in forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root, here = benchutil.tiny_root(tmp_path)
    out = _python(
        "import sys, time, torch\n"
        f"sys.path[:0] = [{benchutil.HERE!r}, {benchutil.ROOT!r}]\n"
        "torch.set_num_threads(2)\n"
        "from benchlib.main import main, forbidden_modules\n"
        f"rc = main(['--workload', {benchutil.TINY_CELL!r}, '--seed', '3',"
        " '--seconds', '0.01', '--trace', '0'],"
        f" {root!r}, time.perf_counter(), require_card=False, device='cpu',"
        f" here={here!r})\n"
        "assert rc == 0, rc\n"
        "assert 'mulls_tpu_torch.parallel.multiseq' in sys.modules\n"
        "print(forbidden_modules())\n")
    assert out == "[]"


def test_the_reference_loads_nothing_of_the_program():
    names = []
    base = os.path.join(benchutil.HERE, "mulls_ref")
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      benchutil.HERE)[:-3]
                names.append(rel.replace(os.sep, ".").replace(
                    ".__init__", ""))
    out = _python(
        "import sys, importlib\n"
        f"sys.path[:0] = [{benchutil.HERE!r}]\n"
        f"for n in {sorted(names)!r}: importlib.import_module(n)\n"
        "import benchlib.check\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'mulls_tpu_torch', 'mulls_tpu', 'jax', 'jaxlib', 'flax'}))\n",
        cwd=benchutil.HERE)
    assert out == "[]"
