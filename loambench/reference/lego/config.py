"""Typed configuration of the PyTorch port.

A field-for-field copy of the port's ten frozen dataclasses (its sensor
presets left out: a configuration file of the benchmark gives every
value), kept here so the reference imports nothing of the port.
`loambench/tests/test_loambench_harness.py` holds each file's values equal
to the port's preset.
Some field comments describe the TPU measurements that set their defaults;
they are the reference's history, not measurements of this port.

All angles are radians internally; the YAML's degree-valued keys are converted
once at construction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

DEG = math.pi / 180.0


@dataclasses.dataclass(frozen=True)
class LaserConfig:
    """Sensor geometry (≙ `laser:` group, loam_config.yaml:4-13)."""

    num_vertical_scans: int = 16
    num_horizontal_scans: int = 1800
    vertical_angle_bottom: float = -15.0 * DEG
    vertical_angle_top: float = 15.0 * DEG
    sensor_mount_angle: float = 0.0
    ground_scan_index: int = 7
    scan_period: float = 0.1
    # VLP-32c irregular-row quantization step (imageProjection.cpp:356)
    vlp32c_row_quant: float = 0.335 * DEG
    use_vlp32c: bool = False
    use_kitti: bool = False
    # Max raw points fed to projection (VLP-16 emits ≈28.8k/scan); fixed pad.
    max_points: int = 32768

    @property
    def ang_res_x(self) -> float:
        return 2.0 * math.pi / self.num_horizontal_scans

    @property
    def ang_res_y(self) -> float:
        return (self.vertical_angle_top - self.vertical_angle_bottom) / max(
            self.num_vertical_scans - 1, 1
        )

    @property
    def ang_bottom(self) -> float:
        """Offset added to elevation before row quantization (positive)."""
        return -self.vertical_angle_bottom


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Cluster segmentation (≙ `image_projection:` group, loam_config.yaml:15-18)."""

    segment_valid_point_num: int = 5
    segment_valid_line_num: int = 3
    segment_theta: float = 60.0 * DEG
    # Segments at least this large are always kept (imageProjection.cpp:913)
    segment_large_point_num: int = 30
    # Cap on label-propagation iterations (run-min sweep + root hooking per
    # iteration) for the connected-components fixed point. Hooking merges
    # whole runs through a root table each iteration, so convergence is
    # ~3-4 iterations (oracle-verified; early exit); 10 bounds pathology.
    label_prop_iters: int = 10
    # Connected-components backend: 'auto' = Pallas VMEM-resident fixpoint
    # kernel on TPU (ops/pallas_cc.py), XLA sweep+hook elsewhere.
    cc_backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class GroundConfig:
    """Ground removal, both variants (imageProjection.cpp:447-774)."""

    # Upstream variant: slope test threshold (imageProjection.cpp:476)
    upstream_angle_threshold: float = 10.0 * DEG
    # "Ours" reference-vector iteration thresholds (imageProjection.cpp:561-571)
    angle_threshold: float = 12.5 * DEG  # VLP-16 value of D
    angle_threshold_low: float = 60.0 * DEG  # KITTI rows < 16
    # ADD pass gates (imageProjection.cpp:644-647)
    add_dr_ratio: float = 0.061
    add_dz_max: float = 0.1
    # ELEVATION pass (imageProjection.cpp:673-698)
    elevation_init_height: float = -1.3
    elevation_margin: float = 0.3
    elevation_min_ground_count: int = 5
    # NEAR pass + RANSAC recovery (imageProjection.cpp:700-735)
    near_depth_max: float = 10.0
    near_reset_depth: float = 5.0
    ransac_distance_threshold: float = 0.5
    ransac_iterations: int = 64
    near_max_points: int = 4096
    use_ours: bool = True


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Feature extraction (≙ `featureAssociation:` group, loam_config.yaml:62-66)."""

    edge_threshold: float = 0.03
    surf_threshold: float = 0.03
    nearest_feature_search_distance: float = 5.0
    # DBSCAN refinement (featureAssociation.cpp:1318-1387; yaml:56-58)
    dbscan_radius: float = 5.0  # DBFr
    dbscan_ratio_xy: float = 0.5  # RatioXY
    dbscan_ratio_z: float = 2.5  # RatioZ
    dbscan_min_cluster: int = 4
    # Fork ("Ours") vs upstream picking (featureAssociation.cpp:901-1316)
    use_ours: bool = True
    # Upstream sector picking caps (featureAssociation.cpp:931-941)
    max_sharp_per_sector: int = 2
    max_less_sharp_per_sector: int = 20
    max_flat_per_sector: int = 4
    num_sectors: int = 6
    # Occlusion marking (featureAssociation.cpp:851-899)
    occlusion_depth_gap: float = 0.3
    occlusion_column_gap: int = 10
    parallel_beam_ratio: float = 0.02
    # Less-flat voxel downsample leaf (featureAssociation.h VoxelGrid 0.2)
    less_flat_leaf: float = 0.2
    # Virtual shadow floor grid (featureAssociation.cpp:412-450)
    use_shadow_points: bool = True
    shadow_rows: int = 16
    shadow_cols: int = 10
    # Fixed capacities (pad-and-mask). less_sharp bounds the O(N^2) DBSCAN
    # matrix — real VLP-16 scans produce a few hundred edge picks.
    max_corner_sharp: int = 512
    max_corner_less_sharp: int = 1024
    # Flats = ground NMS picks + the 160 shadow points; a VLP-16 scan yields
    # a few hundred (measured ~470 on the synthetic world; the every-5th-
    # column ground keep bounds it at ~2.3k worst case).
    max_surf_flat: int = 2048
    max_surf_less_flat: int = 8192
    # Ground-only slice capacity within max_surf_less_flat (the remainder is
    # the structure slice); see ScanFeatures.surf_ground. Clamped to at most
    # half of max_surf_less_flat so shrunken test configs keep a structure
    # slice.
    max_surf_ground: int = 4096

    @property
    def surf_ground_cap(self) -> int:
        return min(self.max_surf_ground, self.max_surf_less_flat // 2)


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Two-step scan-to-scan solver (featureAssociation.cpp:1846-2535)."""

    max_iterations: int = 20
    # Fixed refresh cadence is superseded by motion-triggered refresh (the
    # search reruns when the pose moved > refresh_rot_deg / refresh_trans_m
    # since the last one); kept for reference-parity discussion
    # (featureAssociation.cpp:1588 re-searches every 5th LM iteration).
    search_every: int = 3
    # Motion thresholds that invalidate cached correspondences. 0.2 m voxel
    # spacing in the target clouds means support sets are stable well past
    # these; a constant-velocity warm start keeps most frames at exactly
    # one search per stage.
    refresh_rot_deg: float = 0.5
    refresh_trans_m: float = 0.02
    # Convergence: deltaR < 0.1 deg, deltaT < 0.1 cm (featureAssociation.cpp:2006)
    rot_converge_deg: float = 0.1
    trans_converge_cm: float = 0.1
    # Step damping. The reference damps by 0.05 via `matB = -0.05 * d2`
    # (featureAssociation.cpp:1951) and compensates with up to 100
    # iterations. Exact (1.0) steps interact unstably with eager
    # correspondence refresh: the solver jumps to the cached objective's
    # minimum, the refreshed supports define a new minimum further out, and
    # the (search, minimize) walk has no descent guarantee — measured
    # oscillation up to +-1.8 m/frame on a building campus. 0.7 with the
    # per-iteration clamp below keeps each move inside the current
    # correspondence basin.
    step_scale: float = 0.7
    # Per-iteration trust region (meters / degrees).
    step_clamp_trans: float = 0.06
    step_clamp_rot_deg: float = 1.5
    # Stage-level trust region around the constant-velocity warm start: at
    # 10 Hz the true motion never deviates from it by more than vehicle
    # accel limits; a larger correction is a correspondence failure, so the
    # total stage correction is scaled back to this cap.
    stage_cap_trans: float = 0.25
    stage_cap_rot_deg: float = 8.0
    # Acceleration trust region on the solved per-frame SPEED: |t| is kept
    # within +-accel_cap of the previous frame's speed (a 10 Hz ground
    # vehicle changes speed < 0.05 m/frame^2 = 5 m/s^2). Per-frame noise
    # makes |t| chi-biased UPWARD (E|v+eps| > |v|), and the mapping prior
    # integrates that inflated speed — measured +40% map speed runaway.
    # 0 disables.
    accel_cap: float = 0.03
    eigen_threshold: float = 10.0  # degeneracy gate (featureAssociation.cpp:1974)
    min_correspondences: int = 10
    # Huber-like correspondence weights (featureAssociation.cpp:1678-1683)
    weight_slope_corner: float = 1.8
    weight_slope_surf: float = 1.8
    weight_min: float = 0.1
    # Adjacent-ring window for line/plane tripods (featureAssociation.cpp:1601)
    ring_window: float = 2.5
    # Surf-stage plane-normal gate: query flats are ground picks by
    # construction ("Ours" extraction takes flats from ground only,
    # featureAssociation.cpp:1219-1224), but the less-flat TARGET cloud also
    # contains walls — a support tripod mixing a wall point tilts the fitted
    # plane and biases pitch (measured -0.05 deg/frame deterministic at
    # noise=0, which integrates into quadratic z drift). Require the fitted
    # normal's |z| >= this (0 disables; 0.95 tolerates ~18 deg terrain slope
    # plus vehicle attitude).
    surf_normal_min_z: float = 0.95
    # 5-NN PCA plane fit for the surf stage (see odometry.surf_search5):
    # 5th neighbor must be within this distance, and all 5 neighbors within
    # surf_plane_tol of the fitted plane (coplanarity gate — rejects
    # neighborhoods mixing ground with wall-base points).
    surf_nn_max_dist: float = 1.5
    surf_plane_tol: float = 0.06
    # 5-NN covariance line fit for the corner stage (odometry.corner_search5)
    corner_nn_max_dist: float = 2.0
    corner_line_ratio: float = 3.0
    # Full-6DoF odometry ablation (≙ the reference's full
    # calculateTransformation kept alongside the two-step split,
    # featureAssociation.cpp:2145-2289): lift the per-stage DOF masks so
    # both passes solve all six degrees of freedom.
    full_dof_odometry: bool = False
    # Wheel-odometry prior mode (fork's updateInitialGuess, :2337-2503).
    # "off": pure LM (upstream behaviour, default here)
    # "init": prior seeds LM (upstream-intended behaviour)
    # "override": prior overwrites LM result (reference as-committed ablation)
    odom_prior_mode: str = "off"
    # Lever arm of the wheel-odom frame (featureAssociation.cpp:2396)
    odom_lever_arm: Tuple[float, float, float] = (0.08, 0.0, 0.0377)
    # IMU attitude anchor: per-frame fraction of the attitude error between
    # the solved world orientation and the orientation-resolved IMU (AHRS)
    # attitude that is blended back into the solve (≙ the reference
    # consuming absolute roll/pitch/yaw from its IMU messages,
    # featureAssociation.cpp:323-334 — LOAM-family systems fold that
    # attitude into the final transform). Geometric decay bounds yaw drift
    # at ~(per-frame yaw bias)/weight instead of integrating without bound:
    # pure-lidar yaw drift on a sparse 300 m campus lap was ~5-10 deg/lap,
    # which put every revisit outside any loop-closure search basin. Active
    # only when IMU samples are fed (use_imu_undistortion).
    imu_attitude_weight: float = 0.2


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Scan-to-map optimization (≙ `mapping:` group, loam_config.yaml:21-44)."""

    enable_loop_closure: bool = False
    surrounding_keyframe_search_radius: float = 50.0
    surrounding_keyframe_search_num: int = 50
    history_keyframe_search_radius: float = 15.0
    # History submap half-window for loop verification. The reference's
    # VLP-16 yaml says 50 but ships loop closure OFF; its ACTIVE loop
    # profile (VLP-32c, loam_config.yaml:102) uses 40. 24 keyframes (~7.5 m
    # of trajectory around the candidate) halves the per-attempt ICP cost;
    # measured campus fitness stays 0.004-0.02 with inlier fraction 1.0.
    history_keyframe_search_num: int = 24
    history_keyframe_fitness_score: float = 0.5
    step_size: float = 1.0
    stop_thres: float = 0.05
    iter_count_thres: int = 200
    mapping_frequency_divider: int = 1
    global_map_visualization_search_radius: float = 5000.0
    # Keyframe gate: 0.3 m between keyframes (mapOptmization.cpp:1624; the
    # reference forces it always-true at :1629 — keep that as default)
    keyframe_gate_distance: float = 0.3
    keyframe_gate_always: bool = True
    # Voxel DS leaves (mapOptimization.h downSizeFilter* ctors)
    corner_leaf: float = 0.2
    surf_leaf: float = 0.4
    outlier_leaf: float = 0.4
    submap_surf_leaf: float = 0.4
    history_leaf: float = 0.2
    global_leaf: float = 1.0
    # Correspondence re-search period inside the GN loop. (The reference
    # rebuilds kd-NN every iteration, mapOptmization.cpp:1596-1599; with
    # full GN steps the pose moves little after iteration ~2, so periodic
    # refresh trades negligible accuracy for most of the NN cost. At 8 the
    # 8-iteration solve searches once, from the map-prior pose — the prior
    # is within mm at 10 Hz, and measured ATE is unchanged.)
    search_every: int = 8
    max_gn_iterations: int = 8
    # 5-NN implementation: 'auto' = Pallas streaming kernel on TPU, XLA
    # chunked approx_min_k elsewhere; 'pallas' / 'xla' force one.
    nn_backend: str = "auto"
    # Skip the newest L keyframes when assembling the submap. The newest
    # entries carry the current pose error almost verbatim; matching against
    # them is a unity-gain feedback loop ("lock to yesterday's error") that
    # integrates the odometry prior's chi-biased speed (measured +40%
    # runaway map speed on the campus course). Anchoring to slightly older
    # keyframes turns the loop into an average over the lag window — linear
    # drift bounded by (solve bias / lag) instead. No reference equivalent
    # (its map update ships disabled; this failure mode is unreachable
    # there).
    submap_recency_lag: int = 10
    # Submap rebuild policy: the reference re-assembles the submap every frame
    # (extractSurroundingKeyFrames); with a 50 m search radius the selected
    # set barely changes between 10 Hz frames, so the assembled+downsampled
    # submap is cached and rebuilt only after the vehicle moves
    # submap_rebuild_dist meters or submap_rebuild_every keyframes land.
    submap_rebuild_dist: float = 1.0
    submap_rebuild_every: int = 10
    # Solver gates (mapOptmization.cpp:1444-1570)
    eigen_threshold: float = 100.0
    min_corner_map: int = 10
    min_surf_map: int = 100
    min_sel: int = 50
    nn_valid_dist: float = 1.0  # 5th-NN gate (mapOptmization.cpp:1279)
    # Relative weight of corner residuals in the scan-to-map GN (1.0 =
    # reference behavior; diagnostic ablation knob).
    corner_weight: float = 1.0
    plane_valid_dist: float = 0.2  # plane residual gate (:1420)
    line_ratio: float = 3.0  # eig gate for line fit (:1326)
    # Map-update ablation: the reference ships with the pose update commented
    # out (mapOptmization.cpp:1539-1545). We default it ON (the functional
    # system) and expose the ablation.
    enable_map_update: bool = True
    # Divergence armor (no reference equivalent — the reference's GN barely
    # moves the pose per iteration because its update is the ablation switch
    # above; with the update live, one bad solve on a degenerate submap can
    # launch the pose, the bad pose assembles a bad submap, and the store
    # self-confirms — measured 1e22 ATE on a 2,096-frame campus course).
    # Per-iteration GN trust region:
    step_clamp_rot_deg: float = 2.0
    step_clamp_trans: float = 0.3
    # Whole-solve rejection gate: if the mapping correction moves the pose
    # further than this from the odometry prior, the solve is rejected and
    # the prior is kept (the reference's structure implicitly bounds a frame
    # to mm-scale corrections; a meters-scale jump is always divergence).
    reject_rot_deg: float = 10.0
    reject_trans: float = 1.0
    # Fixed capacities
    max_corner_scan: int = 1024
    max_surf_scan: int = 4096
    # Assembled-submap caps size the mapping 5-NN search (cost is linear in
    # the cap). 50 keyframes x 0.4 m leaf measured ~16k occupied surf voxels
    # on a synthetic drive; 32k/8k keep 2x headroom. Dense campus scenes
    # may need more — overflow drops the spatially-last voxels.
    max_submap_corner: int = 8192
    max_submap_surf: int = 32768
    max_keyframes: int = 20480
    # Loop-closure ICP (mapOptmization.cpp:983-1094)
    icp_max_iterations: int = 100
    icp_max_corr_dist: float = 100.0
    loop_time_gap: float = 30.0
    loop_every_n_frames: int = 2
    # Fixed capacity for accepted loop factors: the pose-graph factor set is
    # padded to chain + max_loop_factors so accepting a closure never changes
    # the jitted solver's shapes (one compile per run). Oldest factors are
    # dropped beyond the cap.
    max_loop_factors: int = 128
    # Cooldowns bounding ICP/graph-solve cost while driving along a revisit
    # (where a candidate is inside the radius at EVERY check): frames to
    # skip after an ICP attempt / after an accepted closure. The reference
    # attempts every 2nd frame and leans on iSAM2's incrementality
    # (mapOptmization.cpp:1915-1917); a relinearized whole-graph solve wants
    # the duty cycle bounded instead.
    loop_attempt_cooldown: int = 10
    loop_accept_cooldown: int = 50
    # Coarse-to-fine loop verification (loopclosure.coarse_align_2d): the
    # occupancy-correlation peak must match at least this FRACTION of the
    # source's occupied structure cells (plus an absolute floor) before the
    # refined ICP runs, and the refined ICP gates correspondences at this
    # distance (the coarse stage already recovered the drift, so the wide
    # reference gate of 100 m only readmits the ground-dominance failure
    # mode).
    loop_coarse_min_frac: float = 0.4
    loop_coarse_min_score: float = 5.0
    # Coarse-search basin. A revisit after a long lap arrives with the
    # INTEGRATED inter-lap drift: +-6 deg x +-8 m (the r4 values) found
    # candidates on a 100 m lap but missed every one on a 300 m lap
    # (measured: 130/130 attempts failed the coarse gate at frac ~0.25 with
    # true offsets beyond the basin). +-15 deg x +-12 m covers the drift of
    # a ~300 m lap at the odometry's measured error rate; cost is one
    # (shifts^2 x cells) @ (cells x yaws) matmul either way.
    loop_coarse_n_yaw: int = 21
    loop_coarse_yaw_step_deg: float = 1.5
    loop_coarse_extent: float = 24.0
    loop_coarse_cell: float = 0.5
    loop_coarse_search: float = 12.0
    loop_icp_corr_dist: float = 2.0
    # Acceptance gates on the refined loop ICP beyond the reference's raw
    # fitness threshold. The fitness of a CORRECT alignment scales with the
    # cloud's voxel leaf (~3 x leaf^2 mean-square correspondence distance:
    # the reference's 0.5 gate ≈ 3 x its 0.4 m history-cloud leaf squared),
    # so the effective gate is min(history_keyframe_fitness_score,
    # loop_fitness_leaf_scale x less_flat_leaf^2) — a 0.55 m-RMS "alignment"
    # of 0.2 m-leaf clouds is two walls glued together, not a loop (measured:
    # campus false positives score 0.28-0.32, true revisits 0.004-0.014).
    # loop_min_inlier_frac additionally requires that fraction of source
    # points to hold a correspondence within loop_icp_corr_dist at the final
    # ICP iterate — partial-overlap false positives fail coverage even when
    # their matched subset fits well.
    loop_fitness_leaf_scale: float = 3.0
    loop_min_inlier_frac: float = 0.6
    global_map_every_n_frames: int = 5
    # Pose-graph noise model. The reference hardcodes chain VARIANCES of
    # 1e-6 rot / 1e-8 trans and a loop variance equal to the raw ICP fitness
    # (mapOptmization.cpp:1618-1620, :1078-1081) — ratios under which a loop
    # factor shifts the chain by ~0.003%: loop closure as committed is
    # decorative. Here the chain carries the odometry's MEASURED per-frame
    # uncertainty (~0.2 deg, ~3 cm at 10 Hz) and the loop variance is the
    # ICP mean-square residual scaled by loop_noise_scale (a converged ICP
    # pose is good to ~residual/sqrt(N) with N in the thousands, so the raw
    # fitness overstates the pose variance by orders of magnitude).
    chain_rot_var: float = 1e-5
    chain_trans_var: float = 1e-3
    loop_noise_scale: float = 0.01
    # Variance FLOOR for loop factors. An ICP fitness of 0.005 with
    # loop_noise_scale alone claims 7 mm pose std — but the clouds are
    # 0.2-0.4 m voxelized, so the measurement is honestly good to ~5 cm.
    # Overweighted loops (vs the sqrt(700*1e-3)=0.8 m/lap chain) force
    # meters of whole-history redistribution whenever two laps' closures
    # disagree by centimeters: measured on the 29-lap Stevens run as
    # graph_max_move growing 0.08 -> 8 m, map blur (cf_mean 0.066 -> 0.13),
    # then zero accepted closures past lap 17 and 23 m divergence.
    loop_var_floor: float = 2.5e-3
    # Apply the whole-graph correction only every Nth accepted closure
    # (factors always accumulate; finalize() always solves). Every live
    # application rewrites all keyframe poses; at Stevens scale (29 laps,
    # ~120 closures) per-accept application churned the map with ~120
    # history rewrites whose residual propagation artifacts accumulated
    # into inter-lap blur (cf_mean 0.066 -> 0.13) until scan-to-map and
    # closure verification both fell off a cliff at lap ~17 — in every
    # stride/weighting configuration tried. The reference's iSAM2 updates
    # per accept, but its Bayes-tree updates are exact and its workload saw
    # ~minutes between closures; batching is the honest fixed-shape
    # equivalent.
    loop_solve_every_accepts: int = 8
    # Anchor-segment reduced pose-graph solve (posegraph.reduced_solve, the
    # production loop-closure path — ≙ iSAM2's incrementality budget,
    # mapOptmization.cpp:63-66): segments of `stride` keyframes are composed
    # into single between-factors and the reduced graph (K/stride anchors)
    # is solved EXACTLY with dense GN — per-accept cost is O(1) in graph
    # diameter, unlike the PCG whole-graph path. Stride 32 ≈ 10 m segments
    # (intra-segment odometry error is cm-scale against multi-meter loop
    # corrections); the LU cost scales as (K/stride)^3 — measured 396 ms at
    # stride 16 / K=20480 on the v5e, ~8x cheaper at 32. Falls back to the
    # largest power-of-2 divisor when max_keyframes % stride != 0.
    posegraph_anchor_stride: int = 32
    # 2 GN iterations: the anchor graph is nearly linear (small residual
    # chain + verified loop factors); the exact LU solve converges in one
    # step and the second catches the relinearization. Each iteration is a
    # full dense LU (~40 ms at 640 anchors on the v5e).
    posegraph_gn_iters: int = 2
    posegraph_trust_rot: float = 0.3
    # Per-anchor translation cap per GN iteration. The exact LU solve does
    # not produce runaway directions (that was the partially-converged-PCG
    # failure mode); the cost-decrease gate is the real armor, and a first
    # closure after a long uncorrected stretch legitimately needs tens of
    # meters.
    posegraph_trust_trans: float = 20.0
    # Loop-closure ICP iteration budget (separate from the generic
    # icp_max_iterations): the coarse 2-D alignment already recovered the
    # inter-lap drift, so the refinement converges in a handful of steps;
    # 100 reference-parity iterations only burn device time on the async
    # attempt path.
    loop_icp_max_iterations: int = 20
    # Source-cloud decimation for the loop ICP: every Nth surf point. The
    # verification statistic (mean-square correspondence distance over
    # thousands of points) is unchanged by 2x subsampling; the ICP cost is
    # linear in source size.
    loop_icp_src_stride: int = 2


@dataclasses.dataclass(frozen=True)
class EskfConfig:
    """Standalone 18-state error-state KF study (myESKF.{h,cpp})."""

    imu_rate: float = 100.0
    lidar_rate: float = 10.0
    gravity: float = 9.81
    # Continuous-time noise densities (myESKF.cpp nominal values)
    acc_noise: float = 1e-2
    gyro_noise: float = 1e-3
    acc_bias_noise: float = 1e-4
    gyro_bias_noise: float = 1e-5
    # Initial covariance diag
    init_pos_var: float = 1e-4
    init_vel_var: float = 1e-2
    init_att_var: float = 1e-4
    init_bias_var: float = 1e-4
    init_grav_var: float = 1e-6
    # Lidar measurement noise (pos + quat residual)
    lidar_pos_var: float = 1e-4
    lidar_att_var: float = 1e-4
    # Ackermann geometry
    wheel_base: float = 0.335
    wheel_radius: float = 0.05


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Multi-chip sharding layout (new capability; no reference equivalent)."""

    mesh_axis_graph: str = "graph"  # factors / keyframes sharded (dp-like)
    mesh_axis_map: str = "map"  # map blocks sharded (tp-like)
    cg_iterations: int = 256
    cg_tolerance: float = 1e-6
    # Use the mesh-sharded pose-graph solver for loop-closure corrections
    # when more than one device is visible. Default ON: multi-device means
    # the solves should ride the mesh (single-device runs are unaffected).
    use_sharded_posegraph: bool = True
    # Shard the backend state (keyframe store + assembled submap) over the
    # device mesh: the jitted mapping programs are then GSPMD-partitioned —
    # submap assembly, 5-NN and GN reductions run distributed with XLA
    # inserting the collectives. Default ON when >1 device is visible and
    # the capacities divide the mesh.
    shard_backend: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    use_imu_undistortion: bool = False
    # Host-side global-map assembly every mapping.global_map_every_n_frames
    # mapped frames (≙ publishGlobalMap's every-5th-frame signal thread,
    # mapOptmization.cpp:775-892, :1919-1921). Off by default: it costs a
    # keyframe-store device_get per publish, which has no consumer in a
    # headless run; the pipeline stashes the latest map in
    # `latest_global_map` when enabled.
    publish_global_map: bool = False
    # Treat input clouds as rigid snapshots (all points captured at scan
    # end): disables the constant-twist rel_time warp in the odometry
    # residuals. The reference ALWAYS warps mid-scan points by the motion
    # estimate (TransformToStart, featureAssociation.cpp:1389-1412), so the
    # default is False; set True only for synthetic rigid-rendered clouds.
    rigid_scans: bool = False
    # Fixed per-scan IMU sample window (pad-and-mask; ≙ the reference's
    # 200-slot ring buffer, featureAssociation.h imuQue*). 64 covers a
    # 400 Hz IMU over one 0.1 s sweep with margin.
    imu_window: int = 64
    odom_frequency: float = 10.0
    # Grid-local voxel packing radius for device DS (meters)
    local_voxel_radius: float = 102.4
    # Host->device feed quantization step (meters). Point clouds cross the
    # host link as int16 fixed-point at this resolution (±131 m at 4 mm),
    # halving feed bytes vs float32; the chunk runner dequantizes on device.
    # 4 mm is well under the VLP-16's ±30 mm range noise. 0 disables
    # quantization entirely: the pipeline then forces the float32 "points"
    # feed even when feed_mode == "range" (a range image cannot be
    # lossless).
    feed_quant: float = 0.004
    # Chunk-feed encoding. "range": the host packs each scan into the
    # (H, W) uint16 range image (+ int8 azimuth residuals) and the device
    # reconstructs xyz analytically — 3x fewer bytes than int16 xyz, no
    # device-side projection scatter, and quantization error is radial-only
    # (no cartesian lattice snapping). "points": int16 xyz feed + on-device
    # projection (needed when per-point attrs beyond geometry must ride).
    feed_mode: str = "range"


@dataclasses.dataclass(frozen=True)
class LegoLoamConfig:
    laser: LaserConfig = dataclasses.field(default_factory=LaserConfig)
    ground: GroundConfig = dataclasses.field(default_factory=GroundConfig)
    segmentation: SegmentationConfig = dataclasses.field(
        default_factory=SegmentationConfig
    )
    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    eskf: EskfConfig = dataclasses.field(default_factory=EskfConfig)
    distributed: DistributedConfig = dataclasses.field(
        default_factory=DistributedConfig
    )
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)

    def replace(self, **kw) -> "LegoLoamConfig":
        return dataclasses.replace(self, **kw)

