"""Which operations give each entry of a batched call the bits of its call
alone, on this device: the measurement behind ``core/batch.py``.

The batched step (``parallel/multiseq.py``) must give each sequence the
bits of its step alone, so every operation it runs over a leading sequence
axis must be batch-invariant.  For each operation below this tool runs it
once over a batch of S inputs and once on each entry alone, and reports
whether entry s of the batched result equals the single result bit for
bit, for S = 2, 3, 4, 8 and 16 (the linear algebra) or 8 (the rest), at the
step's sizes: sums over 131,072 (a scan), 20,480 (the unground cloud),
1,200 and 200 points (the ICP classes); 6 x 6 and 3 x 3 matrices.

Usage:  python -m mulls_tpu_torch.tools.batch_bits [--device cuda|cpu]
            [--out FILE.json]

Prints the card's name and power limit, then one line per operation:
``SAME`` or ``DIFF``.  The CPU run is for the tests, at the sizes above
with one torch thread; without a card ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Sequence

import torch

from mulls_tpu_torch.core.batch import fsum, matmul, matvec, rotate
from mulls_tpu_torch.core.device import resolve_device

POINTS = (131072, 20480, 1200, 200)
LINALG_BATCHES = (2, 3, 4, 8, 16)


def _same(batched, single: Callable, inputs: Sequence[torch.Tensor]) -> bool:
    out = batched(*inputs)
    out = out if isinstance(out, (tuple, list)) else (out,)
    for s in range(inputs[0].shape[0]):
        one = single(*[x[s] for x in inputs])
        one = one if isinstance(one, (tuple, list)) else (one,)
        if not all(torch.equal(b[s], a) for b, a in zip(out, one)):
            return False
    return True


def check(dev: torch.device, points: Sequence[int] = POINTS,
          batches: Sequence[int] = LINALG_BATCHES, seed: int = 0
          ) -> Dict[str, bool]:
    """{operation: batch-invariant} on ``dev``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    res: Dict[str, bool] = {}
    S = 8
    for n in points:
        x, y = rnd(S, n), rnd(S, n, 3)
        J, w, v = rnd(S, n, 6), rnd(S, n), rnd(S, 6)
        R = rnd(S, 3, 3)
        cases = {
            "torch.sum over the points": (lambda x: x.sum(-1),) * 2 + ((x,),),
            "fsum over the points": (lambda x: fsum(x),) * 2 + ((x,),),
            "torch.sum over the points of [.., n, 3]":
                (lambda y: y.sum(-2),) * 2 + ((y,),),
            "fsum over the points of [.., n, 3]":
                (lambda y: fsum(y, -2),) * 2 + ((y,),),
            "norm of 3-vectors": (lambda y: torch.linalg.norm(y, dim=-1),)
            * 2 + ((y,),),
            "stable sort": (lambda x: torch.sort(x, dim=-1, stable=True)[1],)
            * 2 + ((x,),),
            "argmin": (lambda x: torch.argmin(x, -1),) * 2 + ((x,),),
            "points @ R^T (transform)":
                (lambda y, R: y @ R.transpose(-1, -2),) * 2 + ((y, R),),
            "einsum ...ij,...nj->...ni":
                (lambda R, y: torch.einsum("...ij,...nj->...ni", R, y),)
                * 2 + ((R, y),),
            "points rotated by core.batch.rotate": (rotate,) * 2 + ((R, y),),
            "(J w)^T J by matmul":
                (lambda J, w: (J * w[..., None]).transpose(-1, -2) @ J,)
                * 2 + ((J, w),),
            "(J w)^T J by fsum of products":
                (lambda J, w: fsum((J * w[..., None])[..., :, None]
                                   * J[..., None, :], -3),) * 2
                + ((J, w),),
            "J @ x by matmul": (lambda J, v: (J @ v[..., None])[..., 0],
                                lambda J, v: J @ v, (J, v)),
            "J @ x by core.batch.matvec": (matvec,) * 2 + ((J, v),),
        }
        for name, (fb, fs, inputs) in cases.items():
            res[f"{name}, n = {n}"] = _same(fb, fs, inputs)
    for S in batches:
        M = rnd(S, 6, 6)
        M = M @ M.transpose(-1, -2) + torch.eye(6, device=dev)
        b, R = rnd(S, 6), rnd(S, 3, 3)
        T = rnd(S, 4, 4)
        cases = {
            "linalg.solve_ex 6x6": (lambda M, b: torch.linalg.solve_ex(
                M, b)[0], (M, b)),
            "linalg.eigh 6x6": (torch.linalg.eigh, (M,)),
            "linalg.inv_ex 6x6": (lambda M: torch.linalg.inv_ex(M)[0], (M,)),
            "linalg.svd 3x3": (torch.linalg.svd, (R,)),
            "linalg.det 3x3": (torch.linalg.det, (R,)),
            "4x4 @ 4x4 by matmul": (lambda a, c: a @ c, (T, T.flip(0))),
            "4x4 @ 4x4 by core.batch.matmul": (matmul, (T, T.flip(0))),
            "6x6 @ 6 by matmul": (lambda a, c: (a @ c[..., None])[..., 0],
                                  (M, b)),
        }
        for name, (fn, inputs) in cases.items():
            single = (lambda a, c: a @ c) if name == "6x6 @ 6 by matmul" \
                else fn
            res[f"{name}, S = {S}"] = _same(fn, single, inputs)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write a JSON record")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from mulls_tpu_torch.tools.roofline import card_line
    print(card_line(dev), flush=True)
    res = check(dev)
    for name, ok in res.items():
        print(f"{'SAME' if ok else 'DIFF'}  {name}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card_line(dev), "same": res}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
