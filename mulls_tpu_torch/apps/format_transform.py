"""Format transformers (reference `test/format_transformer/`) — port of
``mulls_tpu/apps/format_transform.py`` on this package's own readers and
writers (``io/{dataset,kitti,pcd}.py``):

* bin2pcd  — KITTI velodyne .bin -> .pcd (`kitti_bin2pcd.cpp`)
* txt2pcd  — whitespace xyz[i] text -> .pcd (`txt2pcd.cpp`)
* labelbin2pcd — KITTI .bin + Semantic-KITTI .label -> labeled .pcd
  (`semantic_kitti_label2pcd.cpp`)

Usage:
  python -m mulls_tpu_torch.apps.format_transform bin2pcd IN.bin OUT.pcd
  python -m mulls_tpu_torch.apps.format_transform labelbin2pcd IN.bin IN.label OUT.pcd
  python -m mulls_tpu_torch.apps.format_transform folder --mode bin2pcd IN_DIR OUT_DIR

Host-only: it reads and writes files and runs on no device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mulls_tpu_torch.io.dataset import read_point_cloud
from mulls_tpu_torch.io.kitti import read_kitti_labels
from mulls_tpu_torch.io.pcd import write_pcd


def _convert_one(mode: str, src: str, dst: str, label_path: str = None):
    data = read_point_cloud(src)
    extra = {}
    if mode == "labelbin2pcd":
        labels = read_kitti_labels(label_path)
        n = min(len(labels), len(data["xyz"]))
        # semantic label id travels in the curvature field like the
        # reference stores it (`semantic_kitti_label2pcd.cpp`)
        extra["curvature"] = labels[:n].astype(np.float32)
        data["xyz"] = data["xyz"][:n]
        data["intensity"] = data["intensity"][:n]
    write_pcd(dst, data["xyz"], intensity=data.get("intensity"),
              extra_fields=extra or None)
    return len(data["xyz"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for mode in ("bin2pcd", "txt2pcd"):
        sp = sub.add_parser(mode)
        sp.add_argument("input")
        sp.add_argument("output")
    sp = sub.add_parser("labelbin2pcd")
    sp.add_argument("input")
    sp.add_argument("label")
    sp.add_argument("output")
    sp = sub.add_parser("folder")
    sp.add_argument("--mode", default="bin2pcd",
                    choices=["bin2pcd", "txt2pcd"])
    sp.add_argument("input_dir")
    sp.add_argument("output_dir")
    args = p.parse_args(argv)

    if args.cmd == "folder":
        os.makedirs(args.output_dir, exist_ok=True)
        ext = ".bin" if args.mode == "bin2pcd" else ".txt"
        files = sorted(f for f in os.listdir(args.input_dir)
                       if f.endswith(ext))
        for f in files:
            n = _convert_one(args.mode, os.path.join(args.input_dir, f),
                             os.path.join(args.output_dir,
                                          os.path.splitext(f)[0] + ".pcd"))
            print(f"{f}: {n} points")
        return 0

    n = _convert_one(args.cmd, args.input, args.output,
                     getattr(args, "label", None))
    print(f"{args.output}: {n} points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
