"""Typed configuration tree for mulls_tpu.

Parameter names mirror the reference gflags (reference:
`test/mulls_slam.cpp:27-199`, flag files `script/config/lo_gflag_list_*.txt`)
so that reference config files can be loaded verbatim for parity runs via
:func:`load_flagfile`.

Two kinds of configuration live here:

* **Algorithm parameters** (thresholds, budgets-as-behavior, weights) — these
  mirror the reference semantics one-to-one.
* **Shape contracts** (:class:`ShapeConfig`) — TPU-specific static tensor
  capacities.  The reference uses variable-length clouds; XLA requires static
  shapes, so every cloud is a fixed-capacity masked tensor.  The capacities
  are chosen to comfortably hold the reference's operating points (e.g.
  KITTI HDL-64 at the `lo_gflag_list_kitti_urban.txt` budgets).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ShapeConfig:
    """Static tensor capacities (the TPU 'shape contract').

    All per-class capacities are padded to multiples of 128 lanes where it
    matters for layout.  Invalid slots are masked; every kernel in `ops/`
    treats masked slots as absent.
    """

    # raw scan capacity (KITTI HDL-64 frames are ~120-130k points)
    n_raw: int = 131072
    # unground cloud used as PCA query/support set
    # (reference `--unground_down_fixed_num=20000`)
    n_unground: int = 20480
    # ground points surviving the grid filter + distance-weighted sampling
    n_ground_full: int = 8192
    # full (pre-NMS-budget) per-class clouds
    n_pillar_full: int = 4096
    n_beam_full: int = 4096
    n_facade_full: int = 8192
    n_roof_full: int = 2048
    n_vertex_full: int = 4096
    # ground-filter grid (static G x G cells, origin at cloud min corner)
    grid_dim: int = 160

    def full_capacity(self, name: str) -> int:
        return {
            "ground": self.n_ground_full,
            "pillar": self.n_pillar_full,
            "beam": self.n_beam_full,
            "facade": self.n_facade_full,
            "roof": self.n_roof_full,
            "vertex": self.n_vertex_full,
        }[name]


@dataclass(frozen=True)
class MapShapeConfig:
    """Static per-class capacities of the local feature map ring buffers.

    The reference re-budgets the local map proportionally to a global cap of
    `--local_map_max_pt_num=20000` (`src/map_manager.cpp:73-86`).  Static
    shapes require fixed per-class caps; the defaults below distribute a
    ~20k global budget at the typical KITTI class mix.
    """

    ground: int = 6144
    pillar: int = 1536
    beam: int = 1024
    facade: int = 8192
    roof: int = 512
    vertex: int = 2048

    def capacity(self, name: str) -> int:
        return getattr(self, name)


@dataclass(frozen=True)
class PreprocessConfig:
    """Distance filtering / calibration (reference `mulls_slam.cpp:404-407`)."""

    apply_dist_filter: bool = True
    min_dist_used: float = 1.5
    max_dist_used: float = 120.0
    min_dist_mapping: float = 2.0
    max_dist_mapping: float = 80.0
    vertical_ang_calib_on: bool = False
    vertical_ang_correction_deg: float = 0.0
    apply_scanner_filter: bool = True
    # self/ghost point filter (reference `cfilter.hpp:914-930`)
    scanner_self_radius: float = 1.8
    underground_height_thre: float = -6.0
    approx_scanner_height: float = 1.8
    cloud_down_res: float = 0.0  # pre-voxel-downsample resolution (0 = off)
    # per-cloud overrides for the pairwise reg CLI (`--cloud_1_down_res` /
    # `--cloud_2_down_res`, `test/mulls_reg.cpp:29-30`); <0 = inherit
    cloud_1_down_res: float = -1.0  # target cloud
    cloud_2_down_res: float = -1.0  # source cloud
    # ROI filter: delete the y-band (traffic lane) from the unground cloud
    # (`cfilter.hpp:2367-2374`, `bbx_filter(..., delete_box=true)`)
    apply_roi_filter: bool = False
    roi_min_y: float = 0.0
    roi_max_y: float = 0.0


@dataclass(frozen=True)
class GroundFilterConfig:
    """Dual-threshold grid ground filter (reference `cfilter.hpp:1658-2036`)."""

    gf_grid_size: float = 2.5  # grid_resolution
    gf_in_grid_h_thre: float = 0.25  # max_height_difference
    gf_neigh_grid_h_thre: float = 1.5  # neighbor_height_diff
    gf_max_h: float = 2.0  # max_ground_height (above approx mean height)
    gf_ground_down_rate: int = 12
    gf_nonground_down_rate: int = 3
    gf_down_down_rate: int = 3  # ground "down-down" rate (non-fixed-num path)
    gf_grid_min_pt_num: int = 6
    gf_reliable_neighbor_grid_thre: int = 0
    # 0: off, 1: linear inverse-distance weight, 2: quadratic
    dist_inverse_sampling_method: int = 2
    standard_distance: float = 15.0  # distance where the weight is 1
    # 0: (0,0,1)  1: radius PCA  2: kNN PCA  3: per-grid plane fit
    ground_normal_method: int = 3
    normal_estimation_radius: float = 2.0
    intensity_thre_nonground: float = 150.0  # keep high-intensity points
    apply_grid_wise_outlier_filter: bool = False
    outlier_std_scale: float = 3.0


@dataclass(frozen=True)
class FeatureConfig:
    """Neighborhood PCA + classification (reference `cfilter.hpp:2058-2290`)."""

    cloud_pca_neigh_r: float = 0.7
    cloud_pca_neigh_k: int = 25
    cloud_pca_neigh_k_min: int = 7
    # Semantic-KITTI assistance (`--semantic_assist_on`,
    # `cfilter.hpp:2448-2608`): moving-object pre-filter + per-class label
    # whitelists within the labeled radius
    semantic_assist_on: bool = False
    semantic_labeled_radius: float = 45.0
    # PCA query stride (reference default 2, `mulls_slam.cpp:84`): only
    # every rate-th unground point is PCA'd/classified; the support set
    # stays the full cloud
    pca_down_rate: int = 2
    unit_dist: float = 10.0  # distance-adaptive PCA unit distance
    use_distance_adaptive_pca: bool = False
    # classification thresholds
    linearity_thre: float = 0.62  # edge_thre
    planarity_thre: float = 0.62  # planar_thre
    linearity_thre_down: float = 0.75  # edge_thre_down (non-NMS path)
    planarity_thre_down: float = 0.75
    curvature_thre: float = 0.08
    # angle gates, degrees (converted to sin thresholds like the reference:
    # `mulls_slam.cpp:112-115`)
    pillar_direction_ang: float = 70.0
    beam_direction_ang: float = 10.0
    facade_normal_ang: float = 20.0
    roof_normal_ang: float = 90.0
    beam_max_height: float = 0.5
    roof_height_min: float = 0.0
    feature_pts_ratio_guess: float = 0.3
    # vertex extraction method: 0 off, 2 = neighborhood-rich high curvature
    extract_vertex_points_method: int = 2
    sharpen_with_nms_on: bool = True
    # fixed budgets (the ICP source shapes)
    fixed_num_downsampling_on: bool = True
    ground_down_fixed_num: int = 800
    pillar_down_fixed_num: int = 400
    facade_down_fixed_num: int = 1200
    beam_down_fixed_num: int = 200
    roof_down_fixed_num: int = 200
    unground_down_fixed_num: int = 20000
    vertex_keep_num: int = 1024
    xy_balanced_sector_num: int = 4
    nms_iterations: int = 3  # fixed-point iterations of batched matrix-NMS
    # self-adaptive parameter update (`--adaptive_parameters_on`,
    # `cfilter.hpp:2404-2444` update_parameters_self_adaptive): when the
    # previous frame yielded too few non-ground features, the non-ground
    # stochastic downsample keeps more points next frame
    adaptive_parameters_on: bool = False
    adaptive_nonground_min_expected: int = 200


@dataclass(frozen=True)
class RegConfig:
    """Multi-metric LLS ICP (reference `cregistration.hpp:1114-1440`)."""

    corr_dis_thre_init: float = 1.5  # dis_thre_unit
    corr_dis_thre_min: float = 0.5
    dis_thre_update_rate: float = 1.1
    converge_tran: float = 0.0005
    converge_rot_d: float = 0.001
    # yaw step for the 4-DoF global heading sweep
    # (`--heading_change_step_degree`, `test/mulls_reg.cpp:52`)
    heading_change_step_degree: float = 15.0
    reg_max_iter_num_s2s: int = 20
    reg_max_iter_num_s2m: int = 20
    reg_max_iter_num_m2m: int = 40
    # '1'/'0' per feature: ground, pillar, facade, beam, roof, vertex
    used_feature_type: str = "111110"
    # x-y-z balance, residual (Huber), distance-adaptive, intensity
    corr_weight_strategy: str = "1101"
    z_xy_balance_ratio: float = 1.0
    pt2pt_res_window: float = 0.1
    pt2pl_res_window: float = 0.1
    pt2li_res_window: float = 0.1
    normal_shooting_on: bool = False
    normal_bearing: float = 45.0  # normal-consistency gate (deg)
    sigma_thre: float = 0.5
    # degeneracy-aware solution remapping (TPU-build extension, not in the
    # reference): zero the per-iteration update along eigendirections of
    # the diagonally-whitened 6x6 normal matrix whose eigenvalue falls
    # below this dimensionless threshold — in corridors/intersections the
    # weakly-constrained direction otherwise follows correspondence noise
    # with a confidently-low residual sigma.  0 disables.
    degeneracy_thre: float = 0.045
    min_neccessary_corr_ratio: float = 0.03
    max_bearable_rotation_d: float = 45.0
    min_total_corr_num: int = 40
    min_neccessary_corr_num: int = 20
    dist_weight_base_min: float = 0.7  # get_weight_by_dist_adaptive b_min
    dist_weight_base_max: float = 1.3
    dist_weight_base_step: float = 0.05
    dist_weight_unit_dist: float = 30.0
    intensity_scale: float = 255.0
    residual_weight_after_iter: int = 2
    apply_intersection_filter: bool = True


@dataclass(frozen=True)
class MapConfig:
    """Local map maintenance (reference `src/map_manager.cpp:18-140`)."""

    local_map_radius: float = 80.0
    # only frame points within this range of the scanner are appended to
    # the map (`--append_frame_radius`, `mulls_slam.cpp:143,259`)
    append_frame_radius: float = 60.0
    local_map_max_pt_num: int = 20000
    local_map_max_vertex_pt_num: int = 2000
    append_frame_downsample_rate: int = 1
    map_based_dynamic_removal_on: bool = True
    dynamic_removal_radius: float = 30.0
    dynamic_dist_thre_min: float = 0.3
    near_dist_thre: float = 0.03
    # moving-object step-sanity veto (TPU-build extension; see
    # `pipeline/odometry.py _register_stage`): a healthy-looking solve
    # deviating from the warm motion-model prior by more than this many
    # meters/frame is dynamic-suspect and gets re-registered with
    # dynamic-suspect sources removed.  0 disables.  0.6 m/frame = 6 m/s^2
    # of acceleration at 10 Hz — beyond any vehicle.
    dynamic_step_sanity_thre: float = 0.6
    # the mover veto's own switch (decoupled from `inframe_recovery_on`
    # per round-4 ADVICE: batch users disabling the retry ladder must not
    # silently lose the veto).  Effective only with
    # map_based_dynamic_removal_on, sanity_thre > 0 and
    # initial_guess_mode == 2 (the veto needs a predictive prior).
    dynamic_sanity_veto_on: bool = True
    # rotation-tolerant post-blackout re-acquisition (round-5; reference
    # machinery `cregistration.hpp:1584-1681`): after
    # `yaw_reacquire_blackout`+ consecutive unhealthy frames, sweep
    # heading offsets of +-range around the motion-model prior, one
    # MULLS-ICP per trial, and accept the best healthy solve.  Closes the
    # mover-during-corner blackout (docs/accuracy/NOTES.md
    # dynamic_s1009): the veto correctly holds the model through the
    # capture, but the translation-widened gates alone cannot recover the
    # yaw error a dead-reckoned corner accumulates.
    yaw_reacquire_on: bool = True
    yaw_reacquire_blackout: int = 2
    yaw_reacquire_range_d: float = 45.0
    yaw_reacquire_step_d: float = 9.0
    # in-frame recovery ladder (TPU-build extension): the suspect-retry
    # and dynamic-suspect re-registration run under `lax.cond`, which a
    # single-sequence jit skips on healthy frames — but the multiseq vmap
    # lowers cond to select, so EVERY sequence pays BOTH branches EVERY
    # frame (~2 extra ICPs + NN passes).  The batch pipeline sets this
    # False and relies on the reference's next-frame add_length recovery
    # instead (`mulls_slam.cpp:650-657`); streaming keeps the ladder.
    inframe_recovery_on: bool = True
    # honor the reference's always-on scan-to-scan warm-up for the first
    # `initial_scan2scan_frame_num` frames even when the s2s module is
    # off (`mulls_slam.cpp:631`).  Static so the multiseq pipeline can
    # compile a warm-up program for the first segment and a steady one
    # (without the cond->select warm-up ICP) for the rest.
    warmup_s2s_on: bool = True
    # TPU-build robustness extensions (not in the reference; rationale in
    # docs/ACCURACY.md "corner-exit failure anatomy").  Both key off a
    # confidence DROP relative to the run's own EMA baseline — absolute
    # thresholds misfire in legitimately sparse environments where
    # steady-state confidence is low:
    # skip dynamic removal when the frame's confidence falls below this
    # fraction of the baseline — removal keys off scan-vs-map distance,
    # so a misaligned frame would delete static structure
    dynamic_removal_confidence_drop: float = 0.4
    # arm the next frame's add_length gate widening when confidence falls
    # below this fraction of the baseline even though the registration
    # code is healthy (a starved solve can converge confidently-wrong one
    # frame before failing outright)
    add_length_confidence_drop: float = 0.5
    local_map_recalculation_frequency: int = 30
    map_min_dist_within_feature: float = 0.03
    s2m_frequency: int = 1
    # uniform motion model: 0 none, 1 translation only, 2 full SE(3)
    initial_guess_mode: int = 2
    motion_compensation_method: int = 0
    # WHEN undistortion happens: "post" is reference-faithful — register
    # the distorted scan, then undistort the feature clouds with the
    # MEASURED frame-to-frame transform before map append / s2s handoff
    # (`mulls_slam.cpp:704-715`, `cfilter.hpp:519-549`); "pre" undistorts
    # the raw scan up front with the motion-model PREDICTION (like the
    # reference's optional first-ICP-iteration compensation,
    # `cregistration.hpp:1249-1258`), so registration runs clean-vs-clean.
    # Default "pre": on the rolling-shutter synthetic A/B
    # (tools/motion_comp_ab.py, docs/ACCURACY.md) pre more than halves the
    # drift of off/post at sustained 8 deg/frame yaw — post registers a
    # distorted source against a clean map, leaving a half-sweep bias the
    # prediction path avoids.
    motion_compensation_timing: str = "pre"
    # scan-to-scan pre-registration refining the motion-model guess before
    # scan-to-map (`--scan_to_scan_module_on`, `mulls_slam.cpp:631-665`)
    scan_to_scan_module_on: bool = False
    # always scan-to-scan for the first N frames while the local map warms
    # up (`--initial_scan2scan_frame_num`, `mulls_slam.cpp:631,667`)
    initial_scan2scan_frame_num: int = 2
    # zero-velocity update: lock z when (near) stationary
    # (`--zupt_on_or_not`, `common_nav.cpp:6-22`)
    zupt_on: bool = False
    zupt_tran_thre: float = 0.02
    shapes: MapShapeConfig = field(default_factory=MapShapeConfig)


@dataclass(frozen=True)
class BaselineConfig:
    """Baseline odometry back-ends (reference `--baseline_reg_method`,
    `mulls_slam.cpp:195-198, 634-639`): plain voxel downsample + NDT or
    voxelized GICP instead of feature extraction + MULLS-ICP."""

    method: str = ""  # "" (off) | "ndt" | "gicp"
    voxel_down_size: float = 0.4       # pre-registration downsample
    table_resolution: float = 1.5      # NDT / VGICP voxel grid
    gicp_cov_radius: float = 1.0       # source-point covariance radius
    frame_budget: int = 16384          # fixed frame shape after downsample
    map_budget: int = 40960            # fixed map shape
    max_iter: int = 30
    direct7: bool = True               # NDT neighbor mode


@dataclass(frozen=True)
class SubmapConfig:
    """Submap segmentation + pose graph (reference `utility.hpp:743-792`,
    `src/build_pose_graph.cpp`, `src/graph_optimizer.cpp`)."""

    loop_closure_detection_on: bool = False
    submap_accu_tran: float = 30.0
    submap_accu_rot: float = 90.0
    submap_accu_frame: int = 150
    min_iou_thre: float = 0.4
    min_iou_thre_global_reg: float = 0.5
    neighbor_search_dist: float = 15.0
    min_submap_id_diff: int = 8
    max_used_reg_edge_per_optimization: int = 3
    cooling_submap_num: int = 2
    adjacent_edge_weight_ratio: float = 1.0
    map2map_reliable_sigma_thre: float = 0.04
    # min feature-overlap (correspondence) ratio for accepting a map-to-map
    # registration (`--map_to_map_min_cor_ratio`, `mulls_slam.cpp:566`)
    map_to_map_min_cor_ratio: float = 0.15
    # after this many frames without a successful PGO, odometry drift is
    # assumed large: widen the loop-candidate search and prefer global
    # (coarse) registration over the odometry prior
    # (`--num_frame_thre_large_drift`, `mulls_slam.cpp:505,558`)
    num_frame_thre_large_drift: int = 1000
    overall_loop_closure_searching_on: bool = False
    # global (coarse) registration
    teaser_based_global_registration_on: bool = True
    reciprocal_feature_match_on: bool = False
    best_n_feature_match_on: bool = True
    feature_corr_num: int = 1000
    teaser_min_inlier_count: int = 8
    # PGO
    pose_graph_optimization_method: str = "ceres"  # solver parity label
    equal_weight_on: bool = False
    diagonal_information_matrix_on: bool = False
    robust_kernel_on: bool = False
    free_node_on: bool = False
    framewise_pgo_on: bool = False
    transfer_correct_reg_tran_on: bool = True
    wrong_edge_tran_thre: float = 5.0
    wrong_edge_rot_thre_deg: float = 25.0
    wrong_edge_ratio_thre: float = 0.1
    # TPU-build extension: when every active edge already closes within
    # these residuals, the graph is consistent and the node update is
    # skipped (edges recorded, nodes marked stable, cooling armed) —
    # repeatedly "optimizing" a noise-floor graph lets bounded solves
    # random-walk the trajectory (measured: 40 PGO rounds turned a
    # 0.068% odometry run into 0.69% SLAM; with the skip it holds)
    pgo_min_inconsistency_tran: float = 0.3
    pgo_min_inconsistency_rot_deg: float = 0.6
    # TPU-build extension: drift-aware loop-edge acceptance window.  The
    # reference double-checks coarse transforms against the odometry
    # prediction with FIXED thresholds (3x/10x wrong_edge_tran_thre,
    # `mulls_slam.cpp:551-555`) — 15+ m, far looser than the trajectory
    # error a run that recently passed a PGO consistency check can have.
    # The expected error since the last accepted PGO grows with odometry
    # drift, so the window is base + per_frame * frames_wo_opt (capped at
    # the reference window; disabled in large-drift mode where the prior
    # is officially distrusted).  A fine registration outside the window
    # is retried from the odometry prediction, then arbitrated by the
    # prior-free BEV basin search before being accepted or dropped —
    # without this, a 2 m aliased-mode m2m with healthy sigma walks right
    # through the 15 m reference window (BENCH_r03/r04 loop world).
    loop_check_drift_tol_base: float = 0.6
    loop_check_drift_tol_per_frame: float = 0.015
    loop_check_drift_rot_base_deg: float = 3.0
    loop_check_drift_rot_per_frame_deg: float = 0.03
    inter_submap_t_limit: float = 2.0
    inter_submap_r_limit: float = 0.1
    inner_submap_t_limit: float = 0.1
    inner_submap_r_limit: float = 0.01
    first_time_cov_update_ratio: float = 1.0
    life_long_cov_update_ratio: float = 1.0
    pgo_max_iter: int = 50
    # end-of-run inner-submap refinement iterations
    # (`--max_iter_inner_submap`, `mulls_slam.cpp:839,881`; our exact-GN
    # solver converges in far fewer steps than the reference's LM default)
    inner_refine_max_iter: int = 15
    # TPU-build extension: slots in the device-resident submap bank
    # (`backend/bank.py`, ~0.9 MB HBM each at the KITTI operating point);
    # submaps beyond the capacity spill to host and take the legacy
    # per-pair loop-closure path
    submap_bank_capacity: int = 192


@dataclass(frozen=True)
class MullsConfig:
    """Root configuration."""

    shapes: ShapeConfig = field(default_factory=ShapeConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    ground: GroundFilterConfig = field(default_factory=GroundFilterConfig)
    feature: FeatureConfig = field(default_factory=FeatureConfig)
    reg: RegConfig = field(default_factory=RegConfig)
    map: MapConfig = field(default_factory=MapConfig)
    submap: SubmapConfig = field(default_factory=SubmapConfig)
    baseline: BaselineConfig = field(default_factory=BaselineConfig)
    seed: int = 0

    def replace(self, **kw) -> "MullsConfig":
        return dataclasses.replace(self, **kw)


# --- gflag-file loading -----------------------------------------------------

# gflag name -> (section attr, field name, type)
_FLAG_MAP = {
    "apply_dist_filter": ("preprocess", "apply_dist_filter", bool),
    "min_dist_used": ("preprocess", "min_dist_used", float),
    "max_dist_used": ("preprocess", "max_dist_used", float),
    "min_dist_mapping": ("preprocess", "min_dist_mapping", float),
    "max_dist_mapping": ("preprocess", "max_dist_mapping", float),
    "vertical_ang_calib_on": ("preprocess", "vertical_ang_calib_on", bool),
    "vertical_ang_correction_deg": ("preprocess", "vertical_ang_correction_deg", float),
    "apply_scanner_filter": ("preprocess", "apply_scanner_filter", bool),
    "underground_height_thre": ("preprocess", "underground_height_thre", float),
    "approx_scanner_height": ("preprocess", "approx_scanner_height", float),
    "cloud_down_res": ("preprocess", "cloud_down_res", float),
    "gf_grid_size": ("ground", "gf_grid_size", float),
    "gf_in_grid_h_thre": ("ground", "gf_in_grid_h_thre", float),
    "gf_neigh_grid_h_thre": ("ground", "gf_neigh_grid_h_thre", float),
    "gf_max_h": ("ground", "gf_max_h", float),
    "gf_ground_down_rate": ("ground", "gf_ground_down_rate", int),
    "gf_nonground_down_rate": ("ground", "gf_nonground_down_rate", int),
    "gf_down_down_rate": ("ground", "gf_down_down_rate", int),
    "gf_grid_min_pt_num": ("ground", "gf_grid_min_pt_num", int),
    "gf_reliable_neighbor_grid_thre": ("ground", "gf_reliable_neighbor_grid_thre", int),
    "dist_inverse_sampling_method": ("ground", "dist_inverse_sampling_method", int),
    "ground_normal_method": ("ground", "ground_normal_method", int),
    "intensity_thre_nonground": ("ground", "intensity_thre_nonground", float),
    "cloud_pca_neigh_r": ("feature", "cloud_pca_neigh_r", float),
    "cloud_pca_neigh_k": ("feature", "cloud_pca_neigh_k", int),
    "cloud_pca_neigh_k_min": ("feature", "cloud_pca_neigh_k_min", int),
    "unit_dist": ("feature", "unit_dist", float),
    "linearity_thre": ("feature", "linearity_thre", float),
    "planarity_thre": ("feature", "planarity_thre", float),
    "curvature_thre": ("feature", "curvature_thre", float),
    "pillar_direction_ang": ("feature", "pillar_direction_ang", float),
    "beam_direction_ang": ("feature", "beam_direction_ang", float),
    "facade_normal_ang": ("feature", "facade_normal_ang", float),
    "roof_normal_ang": ("feature", "roof_normal_ang", float),
    "beam_max_height": ("feature", "beam_max_height", float),
    "feature_pts_ratio_guess": ("feature", "feature_pts_ratio_guess", float),
    "sharpen_with_nms_on": ("feature", "sharpen_with_nms_on", bool),
    "fixed_num_downsampling_on": ("feature", "fixed_num_downsampling_on", bool),
    "ground_down_fixed_num": ("feature", "ground_down_fixed_num", int),
    "pillar_down_fixed_num": ("feature", "pillar_down_fixed_num", int),
    "facade_down_fixed_num": ("feature", "facade_down_fixed_num", int),
    "beam_down_fixed_num": ("feature", "beam_down_fixed_num", int),
    "unground_down_fixed_num": ("feature", "unground_down_fixed_num", int),
    "corr_dis_thre_init": ("reg", "corr_dis_thre_init", float),
    "corr_dis_thre_min": ("reg", "corr_dis_thre_min", float),
    "dis_thre_update_rate": ("reg", "dis_thre_update_rate", float),
    "converge_tran": ("reg", "converge_tran", float),
    "converge_rot_d": ("reg", "converge_rot_d", float),
    "reg_max_iter_num_s2s": ("reg", "reg_max_iter_num_s2s", int),
    "reg_max_iter_num_s2m": ("reg", "reg_max_iter_num_s2m", int),
    "used_feature_type": ("reg", "used_feature_type", str),
    "corr_weight_strategy": ("reg", "corr_weight_strategy", str),
    "pt2pt_res_window": ("reg", "pt2pt_res_window", float),
    "pt2pl_res_window": ("reg", "pt2pl_res_window", float),
    "pt2li_res_window": ("reg", "pt2li_res_window", float),
    "normal_shooting_on": ("reg", "normal_shooting_on", bool),
    "normal_bearing": ("reg", "normal_bearing", float),
    "local_map_radius": ("map", "local_map_radius", float),
    "append_frame_radius": ("map", "append_frame_radius", float),
    "max_iter_inter_submap": ("submap", "pgo_max_iter", int),
    "max_iter_inner_submap": ("submap", "inner_refine_max_iter", int),
    # mulls_reg flag-name aliases (`test/mulls_reg.cpp:24-59`): the pairwise
    # CLI names the same parameters differently from the SLAM driver
    "pca_neighbor_radius": ("feature", "cloud_pca_neigh_r", float),
    # reg CLI spelling, typo included (`test/mulls_reg.cpp:39`)
    "pca_distance_adpative_on": ("feature", "use_distance_adaptive_pca", bool),
    "pca_neighbor_count": ("feature", "cloud_pca_neigh_k", int),
    "corr_dis_thre": ("reg", "corr_dis_thre_init", float),
    "corr_num": ("submap", "feature_corr_num", int),
    "reciprocal_corr_on": ("submap", "reciprocal_feature_match_on", bool),
    "fixed_num_corr_on": ("submap", "best_n_feature_match_on", bool),
    "teaser_on": ("submap", "teaser_based_global_registration_on", bool),
    "reg_max_iter_num": ("reg", "reg_max_iter_num_s2s", int),
    "cloud_1_down_res": ("preprocess", "cloud_1_down_res", float),
    "cloud_2_down_res": ("preprocess", "cloud_2_down_res", float),
    "heading_change_step_degree": ("reg", "heading_change_step_degree", float),
    "local_map_max_pt_num": ("map", "local_map_max_pt_num", int),
    "local_map_max_vertex_pt_num": ("map", "local_map_max_vertex_pt_num", int),
    "local_map_recalculation_frequency": ("map", "local_map_recalculation_frequency", int),
    "apply_map_based_dynamic_removal": ("map", "map_based_dynamic_removal_on", bool),
    "dynamic_removal_radius": ("map", "dynamic_removal_radius", float),
    "dynamic_dist_thre_min": ("map", "dynamic_dist_thre_min", float),
    "map_min_dist_within_feature": ("map", "map_min_dist_within_feature", float),
    "s2m_frequency": ("map", "s2m_frequency", int),
    "initial_guess_mode": ("map", "initial_guess_mode", int),
    "motion_compensation_method": ("map", "motion_compensation_method", int),
    "motion_compensation_timing": ("map", "motion_compensation_timing", str),
    "semantic_assist_on": ("feature", "semantic_assist_on", bool),
    "scan_to_scan_module_on": ("map", "scan_to_scan_module_on", bool),
    "zupt_on_or_not": ("map", "zupt_on", bool),
    "baseline_reg_method": ("baseline", "method", str),
    "reg_voxel_size": ("baseline", "voxel_down_size", float),
    "loop_closure_detection_on": ("submap", "loop_closure_detection_on", bool),
    "submap_accu_tran": ("submap", "submap_accu_tran", float),
    "submap_accu_rot": ("submap", "submap_accu_rot", float),
    "submap_accu_frame": ("submap", "submap_accu_frame", int),
    "min_iou_thre": ("submap", "min_iou_thre", float),
    "min_iou_thre_global_reg": ("submap", "min_iou_thre_global_reg", float),
    "neighbor_search_dist": ("submap", "neighbor_search_dist", float),
    "cooling_submap_num": ("submap", "cooling_submap_num", int),
    "adjacent_edge_weight_ratio": ("submap", "adjacent_edge_weight_ratio", float),
    "map2map_reliable_sigma_thre": ("submap", "map2map_reliable_sigma_thre", float),
    "overall_loop_closure_searching_on": ("submap", "overall_loop_closure_searching_on", bool),
    "teaser_based_global_registration_on": ("submap", "teaser_based_global_registration_on", bool),
    "reciprocal_feature_match_on": ("submap", "reciprocal_feature_match_on", bool),
    "best_n_feature_match_on": ("submap", "best_n_feature_match_on", bool),
    "feature_corr_num": ("submap", "feature_corr_num", int),
    "teaser_min_inlier_count": ("submap", "teaser_min_inlier_count", int),
    "free_node_on": ("submap", "free_node_on", bool),
    "inter_submap_t_limit": ("submap", "inter_submap_t_limit", float),
    "inter_submap_r_limit": ("submap", "inter_submap_r_limit", float),
    "inner_submap_t_limit": ("submap", "inner_submap_t_limit", float),
    "inner_submap_r_limit": ("submap", "inner_submap_r_limit", float),
    "first_time_cov_update_ratio": ("submap", "first_time_cov_update_ratio", float),
    "life_long_cov_update_ratio": ("submap", "life_long_cov_update_ratio", float),
    "wrong_edge_tran_thre": ("submap", "wrong_edge_tran_thre", float),
    "wrong_edge_rot_thre_deg": ("submap", "wrong_edge_rot_thre_deg", float),
    "robust_kernel_on": ("submap", "robust_kernel_on", bool),
    "equal_weight_on": ("submap", "equal_weight_on", bool),
    "diagonal_information_matrix_on": ("submap", "diagonal_information_matrix_on", bool),
    "framewise_pgo_on": ("submap", "framewise_pgo_on", bool),
    "transfer_correct_reg_tran_on": ("submap", "transfer_correct_reg_tran_on", bool),
    "pose_graph_optimization_method": ("submap", "pose_graph_optimization_method", str),
    # --- aliases / late additions (reference flag name -> config field)
    "apply_roi_filter": ("preprocess", "apply_roi_filter", bool),
    "roi_min_y": ("preprocess", "roi_min_y", float),
    "roi_max_y": ("preprocess", "roi_max_y", float),
    "gf_normal_estimation_radius": ("ground", "normal_estimation_radius", float),
    "pca_down_rate": ("feature", "pca_down_rate", int),
    "roof_down_fixed_num": ("feature", "roof_down_fixed_num", int),
    "linearity_thre_down": ("feature", "linearity_thre_down", float),
    "planarity_thre_down": ("feature", "planarity_thre_down", float),
    "vertex_extraction_method": ("feature", "extract_vertex_points_method", int),
    "adaptive_parameters_on": ("feature", "adaptive_parameters_on", bool),
    "reg_intersection_filter_on": ("reg", "apply_intersection_filter", bool),
    "post_sigma_thre": ("reg", "sigma_thre", float),
    "z_xy_balance_ratio": ("reg", "z_xy_balance_ratio", float),
    "reg_max_iter_num_m2m": ("reg", "reg_max_iter_num_m2m", int),
    "initial_scan2scan_frame_num": ("map", "initial_scan2scan_frame_num", int),
    "min_submap_id_diff": ("submap", "min_submap_id_diff", int),
    "max_used_reg_edge_per_optimization":
        ("submap", "max_used_reg_edge_per_optimization", int),
    "global_reg_min_inlier_count": ("submap", "teaser_min_inlier_count", int),
    "map_to_map_min_cor_ratio": ("submap", "map_to_map_min_cor_ratio", float),
    "num_frame_thre_large_drift": ("submap", "num_frame_thre_large_drift", int),
    # NDT neighbor search: 7 -> DIRECT7, else DIRECT1 (`ndt_omp.h:51-72`)
    "ndt_searching_method": ("baseline", "direct7",
                             lambda raw: int(raw) == 7),
}

# reference flags with no runtime effect here: visualization-window and
# deprecated/dead flags are accepted silently rather than warned about
_IGNORED_FLAGS = frozenset({
    "real_time_viewer_on", "screen_width", "screen_height",
    "vis_intensity_scale", "vis_map_history_down_rate",
    "vis_map_history_keep_frame_num", "vis_initial_color_type",
    "laser_vis_size", "vis_pause_at_loop_closure", "show_range_image",
    "show_bev_image",
    "detect_curb_or_not",  # "(Deprecated)" in the reference, cfilter.hpp:1387
    "frame_estimated_error_tran", "frame_estimated_error_rot_deg",  # unread
    "bsc_grid_num_per_side",  # BSC descriptor is dead code upstream
    "voxel_gicp_on",  # our GICP baseline is always voxelized (TPU design)
    "motion_compensation_on",  # superseded by motion_compensation_method
    # glog flags passed by the reference run scripts
    "colorlogtostderr", "stderrthreshold", "log_dir", "v",
})


def _parse_value(raw: str, typ):
    raw = raw.strip()
    if typ is bool:
        return raw.lower() in ("true", "1", "yes", "on")
    return typ(raw)


def gflag_bool(raw: str) -> int:
    """argparse type for gflags-style booleans: accepts true/false/1/0
    (the reference run scripts pass e.g. ``--realtime_viewer_on=true``,
    `script/run_mulls_reg.sh`)."""
    return int(_parse_value(str(raw), bool))


def _apply_flag_lines(cfg: MullsConfig, lines) -> MullsConfig:
    sections: dict = {
        "preprocess": dict(), "ground": dict(), "feature": dict(),
        "reg": dict(), "map": dict(), "submap": dict(), "baseline": dict(),
    }
    for line in lines:
        line = line.strip()
        if not line.startswith("--") or "=" not in line:
            continue
        name, _, raw = line[2:].partition("=")
        entry = _FLAG_MAP.get(name.strip())
        if entry is None:
            continue
        section, fname, typ = entry
        sections[section][fname] = _parse_value(raw, typ)
    updates = {}
    for sec, kv in sections.items():
        if kv:
            updates[sec] = dataclasses.replace(getattr(cfg, sec), **kv)
    cfg = dataclasses.replace(cfg, **updates) if updates else cfg
    return derive_shapes(cfg)


def derive_shapes(cfg: MullsConfig) -> MullsConfig:
    """Derive static shape knobs from the operating point.

    The ground-filter grid only needs to cover the dist-filtered cloud
    extent (2 * max_dist_used across); every [G*G]-sized table, pick gather
    and pool in ops/ground.py scales with it, so shrink the static window
    to the needed span (never grow past the ShapeConfig default — out-of-
    window points fall back to the unground path by construction)."""
    span = 2.0 * cfg.preprocess.max_dist_used / max(cfg.ground.gf_grid_size,
                                                    1e-3)
    need = int(math.ceil(span)) + 4
    # cap against the PRISTINE default, not the current (possibly already
    # shrunk) value: derive_shapes runs on every _apply_flag_lines call, so
    # a later CLI override raising --max_dist_used must be able to grow the
    # window back (shrink-only ratcheting silently classified all ground
    # beyond the stale window as unground)
    base_gd = type(cfg.shapes)().grid_dim
    gd = min(base_gd, max(32, -(-need // 8) * 8))
    if gd != cfg.shapes.grid_dim:
        cfg = dataclasses.replace(
            cfg, shapes=dataclasses.replace(cfg.shapes, grid_dim=gd))
    return cfg


def load_flagfile(path: str, base: Optional[MullsConfig] = None) -> MullsConfig:
    """Load a reference-format gflag file (``--name=value`` lines) into a
    :class:`MullsConfig`.  Unknown flags (visualization etc.) are ignored.
    """
    cfg = base or MullsConfig()
    with open(path) as f:
        return _apply_flag_lines(cfg, f)


def apply_flag_overrides(cfg: MullsConfig, args) -> MullsConfig:
    """Apply gflags-style ``--name=value`` command-line overrides on top of
    a config — the reference binaries accept every gflag directly on the
    command line (`test/mulls_slam.cpp:203` ``ParseCommandLineFlags``), not
    only via ``--flagfile``.  Unknown flags warn (visualization-only flags
    of the reference are accepted silently)."""
    import sys
    known, unknown = [], []
    for a in args:
        name = a[2:].partition("=")[0] if a.startswith("--") else ""
        if name in _IGNORED_FLAGS:
            continue
        (known if name in _FLAG_MAP else unknown).append(a)
    for a in unknown:
        print(f"[mulls_tpu] ignoring unknown flag {a!r}", file=sys.stderr)
    return _apply_flag_lines(cfg, known)
