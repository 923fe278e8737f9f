"""mulls_reg-equivalent CLI — port of ``mulls_tpu/apps/reg.py``
(reference `test/mulls_reg.cpp:61-209`): pairwise point-cloud
registration.  Loads two clouds, extracts features, runs a coarse step
(NCC keypoint matching with GNC / RANSAC, FPFH-SAC, the BEV correlation
search or the 4-DoF heading sweep), then MULLS-ICP fine registration;
writes the transformed source cloud and prints the estimated transform
and its quality stats.  Runs on the card by default.

Usage:
  python -m mulls_tpu_torch.apps.reg \
      --point_cloud_1_path target.pcd --point_cloud_2_path source.pcd \
      --output_point_cloud_path source_in_target.pcd --json_out reg.json \
      [--coarse_reg gnc|ransac|fpfh|bev|yaw4dof|none] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from mulls_tpu_torch.backend import coarse_reg as cr
from mulls_tpu_torch.backend.fpfh import coarse_reg_fpfhsac
from mulls_tpu_torch.backend.ncc import match_ncc
from mulls_tpu_torch.config import (MullsConfig, apply_flag_overrides,
                                    gflag_bool, load_flagfile)
from mulls_tpu_torch.core.cloud import FeatureFrame, RawCloud
from mulls_tpu_torch.core.device import resolve_device
from mulls_tpu_torch.core.draws import Draws, GeneratorDraws
from mulls_tpu_torch.frontend.features import extract_features
from mulls_tpu_torch.frontend.icp import mm_lls_icp, mm_lls_icp_4dof_global
from mulls_tpu_torch.io.dataset import (pad_cloud, read_point_cloud,
                                        write_point_cloud)

COARSE_MODES = ("gnc", "ransac", "fpfh", "bev", "yaw4dof", "none")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--point_cloud_1_path", required=True, help="target")
    p.add_argument("--point_cloud_2_path", required=True, help="source")
    p.add_argument("--output_point_cloud_path", default=None)
    p.add_argument("--appro_coordinate_file", default=None,
                   help="4x4 initial guess, whitespace separated")
    p.add_argument("--flagfile", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) | cpu (plain PyTorch paths)")
    p.add_argument("--realtime_viewer_on", type=gflag_bool, nargs="?",
                   const=1, default=0, help="ignored (headless build)")
    p.add_argument("--coarse_reg", choices=COARSE_MODES, default=None,
                   help="coarse init: gnc (TEASER-style), ransac, fpfh "
                        "(SAC-IA), bev (global BEV correlation), yaw4dof "
                        "(brute-force heading sweep, "
                        "`cregistration.hpp:1584-1681`); default follows "
                        "--is_global_reg/--teaser_on like the reference, "
                        "with a BEV fallback when the fine stage rejects")
    p.add_argument("--is_global_reg", type=gflag_bool, default=1,
                   help="allow coarse registration without a good initial "
                        "guess (`test/mulls_reg.cpp:53`)")
    p.add_argument("--json_out", default=None)
    return p


def _side_cfg(cfg: MullsConfig, res_override: float) -> MullsConfig:
    """Per-cloud downsample override (`--cloud_1_down_res` target /
    `--cloud_2_down_res` source, `test/mulls_reg.cpp:29-30,80-81`)."""
    if res_override is None or res_override < 0:
        return cfg
    return dataclasses.replace(cfg, preprocess=dataclasses.replace(
        cfg.preprocess, cloud_down_res=res_override))


def _stack(frame, field: str) -> torch.Tensor:
    return torch.cat([getattr(frame.down["facade"], field),
                      getattr(frame.down["ground"], field)])


def register_pair(cfg: MullsConfig, cloud_target: dict, cloud_source: dict,
                  coarse: str = "gnc", init_guess=None, device="cuda",
                  draws: Optional[Sequence[Draws]] = None):
    """The MULLS-Reg path on ``device``: features of both clouds, then
    :func:`register_frames`.  Returns (T 4x4 float64 numpy, stats dict).
    ``draws`` are three streams: the target's features, the source's and
    the coarse step's (the reference's ``key(1)``, ``key(2)``, ``key(3)``);
    by default generators seeded from ``cfg.seed``."""
    dev = resolve_device(device)
    d_tgt, d_src, d_coarse = draws or [GeneratorDraws(cfg.seed + k, dev)
                                       for k in (1, 2, 3)]

    def features(cloud, res_override, d):
        raw = RawCloud.from_numpy(pad_cloud(cloud, cfg.shapes.n_raw), dev)
        return extract_features(raw, _side_cfg(cfg, res_override), d)

    ft = features(cloud_target, cfg.preprocess.cloud_1_down_res, d_tgt)
    fs = features(cloud_source, cfg.preprocess.cloud_2_down_res, d_src)
    return register_frames(cfg, ft, fs, coarse, init_guess, d_coarse)


def register_frames(cfg: MullsConfig, ft: FeatureFrame, fs: FeatureFrame,
                    coarse: str, init_guess, d_coarse: Draws):
    """Coarse step ``coarse`` (its draws from ``d_coarse``), then MULLS-ICP of
    the source frame ``fs`` onto the target frame ``ft``, with the BEV
    fallback, on the frames' device."""
    dev = ft.bbx_min.device
    stats = {}
    T0 = (torch.eye(4, dtype=torch.float32, device=dev) if init_guess is None
          else torch.as_tensor(np.asarray(init_guess, np.float32),
                               device=dev))
    max_iter = cfg.reg.reg_max_iter_num_s2s
    if coarse == "yaw4dof":
        # brute-force heading sweep over the full circle; no keypoint
        # matching.  The sweep returns (result, seed yaw, score): the
        # reference's CLI reads the tuple as a result and raises
        # AttributeError (`mulls_tpu/apps/reg.py:94`), this one unpacks it
        res, yaw_deg, _ = mm_lls_icp_4dof_global(
            fs.down, ft.full, cfg.reg,
            heading_step_d=cfg.reg.heading_change_step_degree,
            max_iter=max_iter)
        stats["yaw_seed_deg"] = float(yaw_deg)
        stats.update(_fine_stats(res))
        return res.transform.cpu().numpy().astype(np.float64), stats

    def bev_init():
        sx, sm = cr.bev_feature_stack(fs.down)
        tx, tm = cr.bev_feature_stack(ft.down)
        return cr.coarse_reg_bev(sx, sm, tx, tm)

    res_c = None
    if coarse == "bev":
        res_c = bev_init()
    elif coarse == "fpfh":
        # FPFH-SAC (`cregistration.hpp:372-407`) on the downsampled
        # facade + ground geometry (normals from the PCA pass)
        res_c, fitness = coarse_reg_fpfhsac(
            _stack(fs, "xyz"), _stack(fs, "normal"), _stack(fs, "mask"),
            _stack(ft, "xyz"), _stack(ft, "normal"), _stack(ft, "mask"),
            d_coarse, search_radius=cfg.feature.cloud_pca_neigh_r,
            min_inlier_count=cfg.submap.teaser_min_inlier_count)
        stats["fpfh_fitness"] = float(fitness)
    elif coarse in ("gnc", "ransac"):
        m = match_ncc(ft.descriptors, fs.descriptors,
                      fixed_num_corr=cfg.submap.best_n_feature_match_on,
                      corr_num=cfg.submap.feature_corr_num,
                      reciprocal=cfg.submap.reciprocal_feature_match_on)
        sv, tv = fs.down["vertex"], ft.down["vertex"]
        src_k, tgt_k = sv.xyz[m.s_idx], tv.xyz[m.t_idx]
        mask = m.valid & sv.mask[m.s_idx] & tv.mask[m.t_idx]
        nb = cfg.feature.cloud_pca_neigh_r
        if coarse == "gnc":
            res_c = cr.coarse_reg_gnc(
                src_k, tgt_k, mask, d_coarse, noise_bound=nb,
                min_inlier_count=cfg.submap.teaser_min_inlier_count)
        else:
            res_c = cr.coarse_reg_ransac(
                src_k, tgt_k, mask, d_coarse, inlier_thre=2 * nb,
                min_inlier_count=cfg.submap.teaser_min_inlier_count)
    elif coarse != "none":
        raise ValueError(f"unknown coarse mode {coarse!r}")
    if res_c is not None:
        stats["coarse_inliers"] = int(res_c.inlier_count)
        stats["coarse_valid"] = bool(res_c.valid)
        if stats["coarse_valid"]:
            T0 = res_c.transform

    res = mm_lls_icp(fs.down, ft.full, cfg.reg, T0, max_iter=max_iter)
    # descriptor matching degrades at wide baselines (NCC putative sets
    # can coherently prefer a wrong mode); when the fine stage rejects or
    # barely overlaps, retry from the global BEV-correlation basin
    if coarse in ("gnc", "ransac", "fpfh") and (
            int(res.process_code) != 1 or float(res.confidence) < 0.2):
        res_c = bev_init()
        if bool(res_c.valid):
            res2 = mm_lls_icp(fs.down, ft.full, cfg.reg, res_c.transform,
                              max_iter=max_iter)
            if (int(res2.process_code) == 1
                    and float(res2.confidence) > float(res.confidence)):
                res = res2
                stats["coarse_inliers"] = int(res_c.inlier_count)
                stats["coarse_valid"] = True
                stats["bev_fallback"] = True
    stats.update(_fine_stats(res))
    return res.transform.cpu().numpy().astype(np.float64), stats


def _fine_stats(res) -> dict:
    return {"sigma": float(res.sigma),
            "process_code": int(res.process_code),
            "confidence": float(res.confidence),
            "iterations": int(res.iterations)}


def main(argv=None) -> int:
    args, extra = build_parser().parse_known_args(argv)
    cfg = load_flagfile(args.flagfile) if args.flagfile else MullsConfig()
    if extra:  # gflags parity: any --name=value accepted on the CLI
        cfg = apply_flag_overrides(cfg, extra)
    tgt = read_point_cloud(args.point_cloud_1_path)
    src = read_point_cloud(args.point_cloud_2_path)
    guess = None
    if args.appro_coordinate_file:
        guess = np.loadtxt(args.appro_coordinate_file).reshape(4, 4)

    # the reference's switches: no coarse step unless global registration
    # is allowed; TEASER-style GNC or RANSAC by --teaser_on
    # (`test/mulls_reg.cpp:169-178`)
    coarse = args.coarse_reg
    if coarse is None:
        if not args.is_global_reg:
            coarse = "none"
        elif cfg.submap.teaser_based_global_registration_on:
            coarse = "gnc"
        else:
            coarse = "ransac"

    T, stats = register_pair(cfg, tgt, src, coarse=coarse, init_guess=guess,
                             device=args.device)
    print("[mulls_tpu_torch reg] T (source->target):")
    print(np.array_str(T, precision=6, suppress_small=True))
    print(f"[mulls_tpu_torch reg] stats: {stats}")

    if args.output_point_cloud_path:
        moved = src["xyz"] @ T[:3, :3].T.astype(np.float32) + \
            T[:3, 3].astype(np.float32)
        # extension-dispatched like the reference (`mulls_reg.cpp:199-209`
        # -> `DataIo::write_cloud_file`): pcd/las/ply/txt/csv/bin
        write_point_cloud(args.output_point_cloud_path, moved,
                          src.get("intensity"))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"transform": T.tolist(), **stats}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
