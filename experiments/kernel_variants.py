"""Variants of the two cell-grid and tensor-core kernels, each built from
the source in ``mulls_tpu_torch/csrc`` with one change, and timed on the
card beside the kernel as it is: the measurements behind the design notes
of ``csrc/count_within.cu`` and ``csrc/adj_stack.cu``.

``count_within``, on a map-like cloud (a 240 m square of ground and nine
building blocks, 1,134,000 points from numpy's ``default_rng(5)``, its
first 200,000 points as queries at r = 1 m) and on the probe's
20480 x 20480:

* ``walk`` — the kernel as it is: one thread a query;
* ``searches_only`` — the 18 binary searches without the distance loop;
* ``warp_per_run`` — a warp per run of sorted queries in one cell (runs
  cut at 32 queries): the run's searches on 18 lanes, the candidates
  streamed 32 at a time through the lanes as coalesced float4 loads, each
  tested against every query of the run by a ballot.

``adj_stack``, on the probe's 20480 x 20480 (r^2 = 1) with a random bf16
stack of C = 16 and 128 columns:

* ``as_is`` — the kernel as it is (two blocks an SM);
* ``distances_only`` — the adjacency formed, no tensor-core product;
* ``products_only`` — the products with an all-ones adjacency, no
  distance;
* ``ring4_one_block`` — a ring of four stages, one block an SM;
* ``warps8_one_block``, ``warps12_one_block``, ``warps16_one_block`` —
  one block an SM with 8, 12 or 16 consumer warps (rings of 2, 3 and 4
  stages), which leaves ptxas the registers to keep the products
  asynchronous at C = 128.

Every variant that computes the function is held to the plain version
(exact counts; integer stacks exact).  Times are device times
(``torch.profiler``) of the launch alone.  The variants build with
``nvcc`` into ``build/kernel_variants/``.

A record of how the two designs were chosen, kept outside the package
and its tests: each variant is a text edit of the kernel source as it
stood when the two kernels were redesigned, and the script stops with
the edit that no longer applies once a source has moved on.

Usage (from the root of the checkout, on a card):
    python -m experiments.kernel_variants [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from mulls_tpu_torch.core.device import resolve_device
from mulls_tpu_torch.ops import kernels
from mulls_tpu_torch.tools import roofline as rf

# --- count_within: the warp-per-run kernel, inserted before the walk's
# C interface, and the launch that calls it
_WARP_KERNEL = r'''
__global__ void __launch_bounds__(kThreads)
count_within_run_kernel(const float* __restrict__ q,
                        const float* __restrict__ r2,
                        const long long* __restrict__ order,
                        const int* __restrict__ q_cell,
                        const float4* __restrict__ pts,
                        const long long* __restrict__ keys, int n_q,
                        int n_pts, int dim_x, int dim_y, int dim_z,
                        float* __restrict__ out) {
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float4 qs[kThreads];
  const int lane = threadIdx.x & 31;
  const int wbase = threadIdx.x & ~31;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_q;
  int qi = 0, cx = -1, cy = -1, cz = -1;
  float4 me = make_float4(0.0f, 0.0f, 0.0f, -1.0f);
  if (live) {
    qi = static_cast<int>(order[i]);
    me = make_float4(q[3 * qi], q[3 * qi + 1], q[3 * qi + 2], r2[qi]);
    cx = q_cell[3 * i];
    cy = q_cell[3 * i + 1];
    cz = q_cell[3 * i + 2];
  }
  qs[threadIdx.x] = me;
  __syncwarp();
  // every lane shuffles (no short-circuit around a warp-wide shuffle)
  const int px = __shfl_up_sync(kAll, cx, 1);
  const int py = __shfl_up_sync(kAll, cy, 1);
  const int pz = __shfl_up_sync(kAll, cz, 1);
  const bool same = px == cx && py == cy && pz == cz;
  unsigned rest = __ballot_sync(kAll, live && (lane == 0 || !same));
  const int n_live = __popc(__ballot_sync(kAll, live));
  int cnt = 0;
  while (rest) {
    const int a = __ffs(rest) - 1;
    rest &= rest - 1;
    const int b = rest ? __ffs(rest) - 1 : n_live;
    const int sx = __shfl_sync(kAll, cx, a), sy = __shfl_sync(kAll, cy, a),
              sz = __shfl_sync(kAll, cz, a);
    const int r = lane % 9;
    const int y = sy + r % 3 - 1, z = sz + r / 3 - 1;
    const bool inside = lane < 18 && y >= 0 && y < dim_y && z >= 0 &&
                        z < dim_z;
    const long long row = static_cast<long long>(dim_x) *
                          (y + static_cast<long long>(dim_y) * z);
    const long long want =
        !inside ? 0
                : lane < 9 ? row + max(sx - 1, 0)
                           : row + min(sx + 1, dim_x - 1) + 1;
    int at = 0;
    for (int len = n_pts; len > 1;) {
      const int half = len >> 1;
      if (__ldg(keys + at + half - 1) < want) at += half;
      len -= half;
    }
    if (n_pts > 0) at += __ldg(keys + at) < want ? 1 : 0;
    int first[kRows], size[kRows];
    int total = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      first[k] = __shfl_sync(kAll, at, k);
      size[k] = __shfl_sync(kAll, at, 9 + k) - first[k];
      total += size[k];
    }
    for (int c0 = 0; c0 < total; c0 += 32) {
      int j = -1;
      for (int k = 0, f = c0 + lane; k < kRows; ++k) {
        if (j < 0 && f < size[k]) j = first[k] + f;
        f -= size[k];
      }
      const float nan = __int_as_float(0x7fc00000);
      const float4 p = j >= 0 ? __ldg(pts + j)
                              : make_float4(nan, nan, nan, 0.0f);
      for (int k = a; k < b; ++k) {
        const float4 qk = qs[wbase + k];
        const int hits = __popc(__ballot_sync(
            kAll, mulls::sqdist(qk.x, qk.y, qk.z, p) <= qk.w));
        if (lane == k) cnt += hits;
      }
    }
  }
  if (live) out[qi] = static_cast<float>(cnt);
}

}  // namespace
'''

_COUNT_LOOP = """#pragma unroll 4
    for (int j = s; j < e; ++j) {
      const float d2 = mulls::sqdist(qx, qy, qz, __ldg(pts + j));
      cnt += d2 <= rr ? 1 : 0;
    }"""

COUNT_VARIANTS = {
    "walk": [],
    "searches_only": [(_COUNT_LOOP, "    cnt += e - s;")],
    "warp_per_run": [("}  // namespace\n", _WARP_KERNEL),
                     ("  count_within_kernel<<<",
                      "  count_within_run_kernel<<<")],
}

_HIT = """            hit[u] = mulls::sqdist(qx[h], qy[h], qz[h], s[u]) <= rr[h]
                         ? 1.0f
                         : 0.0f;"""
_MMA = "        wgmma_rs<C>(acc, af, b_desc<C>(b_addr + ks * kK * G::kSwz));"
_LB = "__launch_bounds__(kThreads, 2)"
_WARPS = "constexpr int kConsumerWarps = 8; "
_RING = "constexpr int kRing = 2; "


def _one_block(warps: int, ring: int) -> list:
    return [(_LB, "__launch_bounds__(kThreads, 1)"),
            (_WARPS, f"constexpr int kConsumerWarps = {warps}; "),
            (_RING, f"constexpr int kRing = {ring}; ")]


ADJ_VARIANTS = {
    "as_is": [],
    "distances_only": [(_MMA, "        acc[0] += __int_as_float("
                              "(af[0] ^ af[1] ^ af[2] ^ af[3]) & 1);")],
    "products_only": [(_HIT, "            hit[u] = 1.0f;")],
    "ring4_one_block": _one_block(8, 4),
    "warps8_one_block": _one_block(8, 2),
    "warps12_one_block": _one_block(12, 3),
    "warps16_one_block": _one_block(16, 4),
}
# the variants that compute the function, held to the plain version
_EXACT = {"walk", "warp_per_run", "as_is", "ring4_one_block",
          "warps8_one_block", "warps12_one_block", "warps16_one_block"}


def build(variants: dict, source: str, out: Path) -> dict:
    """{name: (ctypes library, ptxas lines)}: each variant of ``source``
    built by one ``nvcc`` (all started together)."""
    text = (kernels._CSRC / source).read_text()
    out.mkdir(parents=True, exist_ok=True)
    for header in kernels._HEADERS:
        (out / header).write_text((kernels._CSRC / header).read_text())
    procs = {}
    for name, edits in variants.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{source}: variant {name} does not "
                                   f"apply: {old[:60]!r}")
            src = src.replace(old, new, 1)
        (out / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels._NVCC_FLAGS, "-shared", "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "C75" in ln]
        libs[name] = (ctypes.CDLL(str(out / f"{name}.so")), ptxas)
    return libs


def map_cloud(seed: int = 5, half: float = 120.0) -> np.ndarray:
    """A 240 m square of ground (900k points) and nine building blocks of
    four facades (26k points each), numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    n = 900_000
    pts = [np.stack([rng.uniform(-half, half, n), rng.uniform(-half, half, n),
                     0.04 * rng.normal(size=n) - 1.73], -1)]
    for cx in (-60.0, 0.0, 60.0):
        for cy in (-60.0, 0.0, 60.0):
            m = 26_000
            side = rng.integers(0, 4, m)
            u = rng.uniform(-22.0, 22.0, m)
            d = 22.0 + 0.03 * rng.normal(size=m)
            wx = cx + np.where(side == 0, d, np.where(side == 1, -d, u))
            wy = cy + np.where(side < 2, u, np.where(side == 2, d, -d))
            pts.append(np.stack([wx, wy, rng.uniform(-1.5, 12.0, m)], -1))
    return np.concatenate(pts).astype(np.float32)


def run(device="cuda") -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the variants are CUDA kernels: they need a card")
    root = kernels.build_root().parent / "kernel_variants"
    count_libs = build(COUNT_VARIANTS, "count_within.cu", root / "count")
    adj_libs = build(ADJ_VARIANTS, "adj_stack.cu", root / "adj")
    ptr, stream = kernels._ptr, kernels._stream
    rec = {"device": torch.cuda.get_device_name(dev), "count_within": [],
           "adj_stack": [], "ptxas": {}}
    for name, (_, ptxas) in {**count_libs, **adj_libs}.items():
        rec["ptxas"][name] = ptxas

    x = rf.probe_inputs(matmul_n=8)
    world = torch.as_tensor(map_cloud(), device=dev)
    probe_q = torch.as_tensor(x["q_map"], device=dev)
    probe_p = torch.as_tensor(x["p"], device=dev)
    cases = [("map-like 200000 x 1134000", world[:200_000].contiguous(),
              world), ("probe 20480 x 20480", probe_q, probe_p)]
    for label, q, p in cases:
        pm = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
        r2 = torch.ones(q.shape[0], device=dev)
        index = kernels.cell_index(p, pm, r2)
        order, cells = kernels.query_cells(q, index)
        cells = cells.to(torch.int32).contiguous()
        n = min(4096, q.shape[0])
        want = kernels.count_within_plain(q[:n], p, pm, r2[:n])
        out = torch.empty(q.shape[0], device=dev)
        for name, (lib, _) in count_libs.items():
            fn = lib.mulls_count_within
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
                [ctypes.c_void_p] * 2

            def call():
                err = fn(ptr(q), ptr(r2), ptr(order), ptr(cells),
                         ptr(index.points), ptr(index.keys), q.shape[0],
                         index.keys.shape[0], *index.dims, ptr(out),
                         stream(q))
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            call()
            torch.cuda.synchronize()
            exact = (bool(torch.equal(out[:n], want)) if name in _EXACT
                     else None)
            ms = rf.device_ms(call, 10)[0]
            rec["count_within"].append({"case": label, "variant": name,
                                        "device_ms": ms, "exact": exact})
            print(f"[variants] count_within {label:28s} {name:18s} "
                  f"{ms:.4f} ms" + ("" if exact is None
                                    else f", exact {exact}"), flush=True)

    pm = torch.ones(probe_p.shape[0], dtype=torch.bool, device=dev)
    r2 = torch.ones(probe_q.shape[0], device=dev)
    p4 = torch.cat([probe_p, torch.zeros_like(probe_p[:, :1])], 1)
    qn, pn = probe_q.shape[0], probe_p.shape[0]
    for c in (16, 128):
        g = torch.Generator(device=dev).manual_seed(c)
        ints = (torch.arange(1, c + 1, device=dev, dtype=torch.float32)[None]
                * torch.randint(-2, 3, (pn, 1), generator=g, device=dev)
                ).to(torch.bfloat16)
        want = rf.adj_stack_plain(probe_q, probe_p, pm, r2, ints)
        sums = torch.empty((qn, c), device=dev)
        for name, (lib, _) in adj_libs.items():
            fn = lib.mulls_adj_stack
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
                [ctypes.c_void_p] * 2

            def call():
                err = fn(ptr(probe_q), ptr(r2), ptr(p4), ptr(ints), qn, pn,
                         c, ptr(sums), stream(probe_q))
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            call()
            torch.cuda.synchronize()
            exact = (bool(torch.equal(sums, want)) if name in _EXACT
                     else None)
            ms = rf.device_ms(call, 20)[0]
            rec["adj_stack"].append({"case": f"probe {qn} x {pn}", "c": c,
                                     "variant": name, "device_ms": ms,
                                     "exact": exact})
            print(f"[variants] adj_stack C={c:<3d} {name:18s} {ms:.4f} ms"
                  + ("" if exact is None else f", exact {exact}"),
                  flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(rf.card_line(dev), flush=True)
    rec = run(dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
