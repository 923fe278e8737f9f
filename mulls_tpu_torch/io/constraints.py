"""Pose-graph constraint file I/O.

Text format written/parsed by the reference (`dataio.hpp:1247-1337`,
record layout from the ``constraint_t`` stream overload `dataio.hpp:97-109`):

* 7 free-text header rows
* one row with the global shift from world (e.g. UTM) to map coords
* one separator token row
* per constraint:
  ``unique_id  con_type  block1_id  block1_type  block2_id  block2_type``
  followed by 4 rows of ``Trans1_2`` (4x4) and 6 rows of the 6x6
  information matrix.

The reference's enum values (`utility.hpp:139-157`):
``ConstraintType: REGISTRATION=0 ADJACENT=1 HISTORY=2 SMOOTH=3 NONE=4``;
``DataType: ALS=0 TLS=1 MLS=2 BPLS=3 RGBD=4 SLAM=5``.  Our backend uses
different in-memory codes (`backend/submap.py:41`); the writer converts.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# reference enum values
REF_REGISTRATION, REF_ADJACENT, REF_HISTORY, REF_SMOOTH, REF_NONE = range(5)
REF_SLAM_BLOCK = 5

# backend/submap.py kinds -> reference ConstraintType
_KIND_TO_REF = {2: REF_REGISTRATION, 1: REF_ADJACENT, 0: REF_HISTORY,
                -1: REF_NONE}
_REF_TO_KIND = {v: k for k, v in _KIND_TO_REF.items()}

_HEAD = [
    "# mulls_tpu pose-graph constraint file",
    "# format parity: MULLS dataio.hpp:1247-1337",
    "# record: unique_id con_type block1_id block1_type block2_id block2_type",
    "#         4 rows Trans1_2 (4x4)",
    "#         6 rows information matrix (6x6)",
    "# con_type: REGISTRATION=0 ADJACENT=1 HISTORY=2 SMOOTH=3 NONE=4",
    "# block_type: SLAM=5",
]


def write_constraint_file(path: str, edges: Sequence,
                          global_shift=(0.0, 0.0, 0.0)) -> int:
    """Write backend ``Edge`` records (``backend/submap.py``) in the
    reference's constraint-file format.  Returns the number written."""
    with open(path, "w") as f:
        for row in _HEAD:
            f.write(row + "\n")
        f.write("%.8f\t%.8f\t%.8f\n" % tuple(float(x) for x in global_shift))
        f.write("----------------\n")
        n = 0
        for uid, e in enumerate(edges):
            con_type = _KIND_TO_REF.get(int(e.kind), REF_NONE)
            f.write(f"{uid}\t{con_type}\t{int(e.i)}\t{REF_SLAM_BLOCK}\t"
                    f"{int(e.j)}\t{REF_SLAM_BLOCK}\n")
            T = np.asarray(e.T, np.float64)
            info = np.asarray(e.info, np.float64)
            for r in range(4):
                f.write("\t".join("%.8g" % v for v in T[r]) + "\n")
            for r in range(6):
                f.write("\t".join("%.8g" % v for v in info[r]) + "\n")
            n += 1
    return n


def read_constraint_file(path: str) -> Tuple[np.ndarray, List[dict]]:
    """Parse a constraint file (same tolerance as the reference's
    whitespace-token reader).  Returns (global_shift [3], constraints);
    each constraint is a dict with ``unique_id, kind (backend code),
    block1, block2, T [4,4], info [6,6]``.  NONE records are dropped
    like the reference (`dataio.hpp:1318-1319`)."""
    with open(path) as f:
        lines = f.readlines()
    # skip the 7 header rows, then token-stream the rest
    tokens: List[str] = []
    for ln in lines[7:]:
        tokens.extend(ln.split())
    pos = 0

    def take(k):
        nonlocal pos
        out = tokens[pos:pos + k]
        pos += k
        return out

    shift = np.asarray([float(x) for x in take(3)], np.float64)
    take(1)  # separator token
    cons: List[dict] = []
    while pos + 6 + 16 + 36 <= len(tokens):
        uid, con_type, b1, _b1t, b2, _b2t = (int(float(x)) for x in take(6))
        T = np.asarray([float(x) for x in take(16)],
                       np.float64).reshape(4, 4)
        info = np.asarray([float(x) for x in take(36)],
                          np.float64).reshape(6, 6)
        if con_type == REF_NONE:
            continue
        cons.append(dict(unique_id=uid,
                         kind=_REF_TO_KIND.get(con_type, 0),
                         block1=b1, block2=b2, T=T, info=info))
    return shift, cons
