"""Typed configuration for every pipeline hyperparameter.

A field-for-field copy of ``rspc_tpu/config.py`` (importing that module
would import jax through ``rspc_tpu/__init__.py``). The defaults are the
reference's, each field citing where the constant lives in the reference
sources; ``tests/test_torch_config.py`` asserts every default equals the
JAX package's. TPU-only knobs (``use_pallas``, ``target_chunk``, ...) stay
for parity: in this package NN dispatch follows the tensor's device.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Point-to-point ICP settings.

    Defaults mirror the reference's coarse+fine ICP stages, which share one
    parameter set (src/icp_edge_based_registration.hpp:41-52,
    src/ndt_edge_based_registration.hpp:47-50, src/incremental_icp.hpp:46-49).

    NOTE: with PCL's convergence-criteria mapping, ``transformation_epsilon=1``
    sets the translation threshold to 1 m^2 and the rotation threshold to
    cos(angle) >= 1 - 1 = 0, so PCL declares CONVERGENCE_CRITERIA_TRANSFORM
    after the FIRST iteration for any sane incremental step. Parity requires
    honoring that logic, not just running max_iterations (SURVEY.md §6
    "Hard parts").
    """

    max_iterations: int = 100            # setMaximumIterations(100)
    max_correspondence_distance: float = 0.01  # setMaxCorrespondenceDistance(0.01)
    transformation_epsilon: float = 1.0  # setTransformationEpsilon(1)
    euclidean_fitness_epsilon: float = 1000.0  # setEuclideanFitnessEpsilon(1000)
    # PCL internals required for parity (pcl::DefaultConvergenceCriteria):
    mse_threshold_absolute: float = 1e-12   # PCL default absolute MSE threshold
    min_number_correspondences: int = 3     # PCL Registration default
    # Correspondence-to-transform estimator: "point_to_point" is PCL's
    # TransformationEstimationSVD (the reference's setting);
    # "point_to_plane" is the beyond-reference fine-alignment variant
    # (PCL analog TransformationEstimationPointToPlaneLLS) — requires
    # target clouds that carry normals (edge clouds do).
    variant: str = "point_to_point"
    # Optional Huber-style robust reweighting of point-to-plane residuals:
    # w *= min(1, delta / |r|). None = plain least squares. Mitigates the
    # bias from correspondences across depth discontinuities.
    huber_delta: float | None = None
    # Point-to-point blend weight inside the point-to-plane solve
    # (see ops/umeyama.plane_fit). 0 (default) = pure point-to-plane with
    # eigenvalue-floored solves (unobserved directions stay put). A
    # positive mix adds absolute point constraints but risks lattice
    # aliasing between voxel-downsampled clouds.
    point_plane_mix: float = 0.0
    # Colored-ICP residual weight (Park, Zhou, Koltun ICCV 2017; see
    # ops/colorgrad.py). Adds rows ``g . (T src - dst) + (I_dst -
    # I_src)`` to the point-to-plane 6x6 solve, where ``g`` is the
    # target's tangent-plane intensity gradient (Cloud.cgrad) — the
    # in-plane observability the geometric plane residual lacks on
    # weakly-textured planar scenes. 0 (default) disables; requires a
    # target cloud carrying cgrad (RefineConfig.color wires it through
    # phase 1 + the voxel downsample). Units: the color residual is in
    # intensity ([0,1]) while the plane residual is in meters, so the
    # effective trade-off also scales with |g| (intensity/meter).
    color_weight: float = 0.0
    # Huber delta for the color residual, in intensity units. Rejects
    # specular highlights / exposure steps whose intensity mismatch no
    # rigid motion can explain. None = plain least squares.
    color_huber_delta: float | None = 0.05
    # TPU execution knobs (no reference analog):
    # Strided source-subsample cap for the solve (0 = all points, PCL
    # behavior). Every NN sweep is linear in the source count and the
    # LLS pose estimate degrades only as 1/sqrt(n); the caller still
    # transforms/merges the full cloud (see icp_align).
    max_source_points: int = 0
    target_chunk: int = 2048   # target tile size for the XLA NN sweep
    use_pallas: bool = True    # Pallas NN kernel on TPU (auto-falls back
                               # to the XLA sweep on other backends)
    # (A cell-bucketed capped NN backend — O(N * 27 * budget) instead of
    # O(N * M) — was built and measured IN the pipeline on-chip in r3:
    # 3-5x SLOWER at every real shape (north-star chain 0.26 s -> 1.18 s,
    # incremental 6x307k 0.37 s -> 1.15 s, identical accuracy). Its
    # per-point searchsorted + budget-bounded gathers are latency-bound
    # on TPU, while the brute sweeps are VPU-throughput-bound with no
    # size cliff (the HBM-streaming kernel covers multi-million-point
    # targets). Removed rather than left as an unused flag; measurement
    # recorded in RESULTS.md.)
    compute_fitness: bool = True  # getFitnessScore() pass after aligning;
                                  # costs one extra NN sweep — pipeline
                                  # stages whose fitness is never read
                                  # (e.g. the coarse stage) disable it


@dataclasses.dataclass(frozen=True)
class NDTConfig:
    """Normal Distributions Transform settings.

    Defaults from src/ndt_edge_based_registration.hpp:38-43; PCL internals
    (outlier ratio, line-search constants, min points per voxel) from
    pcl::NormalDistributionsTransform defaults.
    """

    transformation_epsilon: float = 0.01  # setTransformationEpsilon(0.01)
    step_size: float = 0.1                # setStepSize(0.1)
    resolution: float = 1.0               # setResolution(1.0)
    max_iterations: int = 50              # setMaximumIterations(50)
    outlier_ratio: float = 0.55           # PCL default
    min_points_per_voxel: int = 6         # PCL VoxelGridCovariance default
    line_search_max_iterations: int = 10  # PCL computeStepLengthMT max
    # PCL-exact line search (parity instrument, VERDICT r3 #2): refresh
    # the voxel neighborhood at EVERY line-search trial (PCL's
    # computeStepLengthMT calls computeDerivatives — and thereby
    # radiusSearch — per trial) and run the full More-Thuente trial
    # selection (psi/phi auxiliary switching, cubic/quadratic/secant
    # interpolation, interval update cases U1-U3) instead of the shipped
    # safeguarded bisection against a frozen neighborhood. Costs one
    # neighborhood gather per trial; measured deltas vs the frozen mode
    # are recorded in RESULTS.md (the divergence PARITY.md X2 documents).
    pcl_exact_line_search: bool = False
    # Score neighborhood per source point: 27 = full 3^3 adjacency
    # (exactly PCL's radiusSearch(resolution), the default); 7 = center +
    # faces (ndt_omp's DIRECT7 — ~4x fewer gathers in the hot path for
    # near-identical optima); 1 = containing cell only (DIRECT1).
    neighborhood: int = 27
    # Dense voxel grid dimension (TPU knob): cells per axis,
    # spanning dense_grid_dim * resolution meters from the occupied
    # bounding box's min corner. One gather replaces a binary search in
    # the hot score/derivative path.
    dense_grid_dim: int = 32
    # Source subsample cap for the NDT solve (TPU knob; 0 = use all
    # points, PCL behavior). The coarse stage only needs enough points to
    # land in the fine stage's basin, and every Newton/line-search pass
    # is linear in the source count. Voxel-downsampled clouds come out in
    # hash-shuffled voxel order, so a PREFIX SLICE of the buffer is
    # already a spatially uniform subsample — no extra shuffle pass.
    max_source_points: int = 0
    # Dense compact-cell sweep (TPU knob; 0 = off, the default: the
    # widened-table gather path evaluates EVERY cell exactly with no
    # cap. -1 = auto: 512 cells when neighborhood == 27, where the sweep
    # measures ~1.9x per align — opt-in because any scene occupying more
    # valid cells than the cap silently loses the dropped cells'
    # evidence, and exact-by-default wins that trade). >0: explicit cap;
    # once per align, compact the grid's VALID cells
    # (typically a few hundred of D^3) into a [C]-row table and evaluate
    # the score/derivatives as a dense [N x C] broadcast sweep —
    # radius + adjacency + validity as an elementwise mask, per-cell
    # channels reduced over C BEFORE the 10x10 gram matmul. Zero gathers
    # inside the Newton loop (the roofline's named bottleneck: the
    # per-iteration neighborhood row gather is latency-bound at ~1.1 ms
    # while the whole evaluation is ~3 MFLOP). Mathematically identical
    # to the gather path (same frozen-neighborhood semantics; proof of
    # mask equivalence in registration/ndt.py::_compact_cells). Valid
    # cells beyond the cap are dropped — size it generously (a 10-frame
    # room at 1 m resolution occupies ~200-800 cells).
    sweep_cells: int = 0


@dataclasses.dataclass(frozen=True)
class EdgeConfig:
    """Organized edge detection + normal estimation settings.

    Normal estimation: AVERAGE_3D_GRADIENT, max depth change 0.02,
    smoothing size 10.0 (src/edge_extractor.hpp:10-15). Edge detection:
    depth discontinuity threshold 0.2, max search neighbors 50, all five
    edge label classes enabled (src/edge_extractor.hpp:17-21). Canny
    hysteresis thresholds are PCL's OrganizedEdgeFromRGB defaults (40, 100);
    high-curvature canny thresholds are PCL's OrganizedEdgeFromNormals
    defaults (0.4, 1.1).
    """

    max_depth_change_factor: float = 0.02
    normal_smoothing_size: float = 10.0
    depth_discontinuity_threshold: float = 0.2
    max_search_neighbors: int = 50
    canny_low_threshold: float = 40.0
    canny_high_threshold: float = 100.0
    hc_canny_low_threshold: float = 0.4
    hc_canny_high_threshold: float = 1.1
    # Which label classes to compute (PCL setEdgeType bitmask analog).
    # The reference enables all five (src/edge_extractor.hpp:21) but only
    # consumes RGB_CANNY; restricting the set skips the corresponding
    # image sweeps (the depth-discontinuity search alone is ~50 shifted
    # passes per frame).
    edge_types: tuple = (
        "nan_boundary", "occluding", "occluded", "high_curvature",
        "rgb_canny",
    )
    # Static capacity of the compacted edge cloud (TPU knob):
    max_edge_points: int = 16384
    # Carry tangent-plane intensity gradients (ops/colorgrad.py) on the
    # edge cloud, enabling the colored-ICP residual in edge-cloud stages
    # whose ICPConfig.color_weight > 0 (RGB canny edges are exactly the
    # high-gradient pixels, so the signal is strongest here). Costs the
    # gradient field's image-space passes in phase 1 plus 3 floats/point
    # on the edge cloud.
    carry_cgrad: bool = False


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    """Approximate voxel-grid downsampling.

    Leaf size 0.01 m^3 from setLeafSize(0.01, 0.01, 0.01)
    (src/icp_edge_based_registration.hpp:47). ``max_points`` is the static
    output capacity (TPU knob).
    """

    leaf_size: float = 0.01
    max_points: int = 16384


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Beyond-reference full-cloud point-to-plane refinement stage.

    The reference's pipeline fine-aligns on RGB-edge clouds only; edge
    points are pixel-grid samples of texture boundaries, which biases
    point-to-point ICP by up to ~z/fx per point along the surface. When
    enabled, a third alignment stage refines each pair on the *full*
    voxel-downsampled clouds with point-to-plane residuals against the
    accumulated surface: voxel means of coplanar points stay on the
    plane, so the in-plane sampling bias projects out entirely.

    Off by default: the default pipeline is reference-parity.
    """

    enabled: bool = False
    leaf_size: float = 0.04   # coarser than the edge voxel: surface
                              # sampling density, not feature density
    max_points: int = 8192    # per-frame capacity after downsampling
    # Pixel decimation before the full-cloud voxel downsample: keep every
    # d-th row/column of the organized image. At leaf 0.04 and typical
    # indoor depths a voxel spans >10 pixels per axis, so d=2 still leaves
    # dozens of samples per voxel mean — but cuts the downsample's
    # sort+scatter traffic by d^2 (the dominant phase-1 cost at full res).
    decimate: int = 1
    # Drop voxels whose mean-normal length |sum n|/count is below this
    # (0 = keep all). Cells straddling creases / depth discontinuities
    # average opposing normals to a short vector and their mean point
    # lies on neither surface — a consistent point-to-plane bias source
    # (see ops/voxel.voxel_downsample).
    normal_purity: float = 0.0
    # Carry tangent-plane intensity gradients (ops/colorgrad.py) on the
    # full downsampled clouds, enabling the colored-ICP residual in any
    # stage whose ICPConfig.color_weight > 0. Costs three image-space
    # difference passes in phase 1 plus 3 floats/point through the
    # voxel downsample and chain carries.
    color: bool = False
    # In-chain refinement: refine each pair against the ACCUMULATED full
    # surface inside the frame chain (improves the targets later frames
    # align to, but its small per-pair bias accumulates as drift).
    chain: bool = True
    # Anchor refinement: after the chain, re-align every frame's full
    # cloud DIRECTLY against frame 0's (batched over frames). Drift-free
    # where the trajectory keeps overlap with the first frame; frames the
    # acceptance gate rejects keep their chain transform. Beyond-reference
    # accuracy stage.
    anchor_to_first: bool = False
    # Anchor target choice. "first": batched one-shot anchoring of every
    # frame against frame 0 (fast — one flattened NN sweep per
    # iteration; drift-free only where the trajectory keeps frame-0
    # overlap). "map": progressive anchoring — frames refine
    # SEQUENTIALLY against a growing map of all previously accepted
    # frames (frame 0 first), and each accepted correction carries onto
    # the next frame's start. Handles partial-overlap trajectories that
    # rotate away from frame 0 (a local-map SLAM step, scan-fused);
    # costs ~n sequential refine solves instead of one batched one.
    anchor_mode: str = "first"
    # Per-frame source-point budget for the batched "first" anchor's
    # iteration sweeps (0 = all points). The anchor is NN-throughput
    # bound (each iteration flattens [B, N] sources into one sweep
    # against frame 0); a strided subsample cuts that proportionally,
    # and a 10k-point point-to-plane fit loses almost nothing at 4096
    # points. The acceptance gate's before/after stats use the SAME
    # subsample, so its relative thresholds are unaffected.
    anchor_max_points: int = 0
    # EXPERIMENTAL: pose-graph relaxation (registration/posegraph.py).
    # After the anchor stage, align every (i, i+off) frame pair for off
    # in pose_graph_skips, weight each relative measurement by its
    # inlier count (dropping non-overlapping pairs), add anchor-prior
    # constraints, and solve the robust SE(3) graph. Redundant
    # constraints AVERAGE per-pair noise instead of integrating it —
    # built for noisy partial-overlap trajectories where no anchor
    # target stays visible. Status: solver + integration are tested;
    # on low-resolution noisy scenes the pairwise measurements are weak
    # enough that the result is ~neutral vs anchoring alone — expect
    # gains only where redundant constraints are well-conditioned.
    pose_graph: bool = False
    pose_graph_skips: tuple = (1, 2, 3)
    # Anchor stage schedule: starts are already chain-initialized (a few
    # mm off), so no wide/loose stage — with partial overlap a wide
    # correspondence cap matches across the non-overlap boundary and
    # drags the pose toward a biased optimum.
    anchor_stages: tuple = (
        ICPConfig(
            max_iterations=4,
            max_correspondence_distance=0.1,
            transformation_epsilon=1e-12,
            euclidean_fitness_epsilon=1e-12,
            mse_threshold_absolute=1e-16,
            variant="point_to_plane",
            huber_delta=0.005,
            compute_fitness=False,
            use_pallas=False,  # runs under vmap
        ),
        ICPConfig(
            max_iterations=3,
            max_correspondence_distance=0.03,
            transformation_epsilon=1e-12,
            euclidean_fitness_epsilon=1e-12,
            mse_threshold_absolute=1e-16,
            variant="point_to_plane",
            huber_delta=0.002,
            compute_fitness=False,
            use_pallas=False,
        ),
    )
    # Acceptance margin: the refined transform is kept only if it improves
    # the capped NN score by this factor. A near-optimal input barely moves
    # the score (the refinement would only swap one ~mm-scale bias for
    # another), while a genuinely misaligned input improves it several-fold
    # — so the margin makes refine engage exactly when the coarse chain
    # failed.
    accept_margin: float = 0.75
    # Anchor acceptance-gate constants (_anchor_refine). Sensitivity is
    # pinned by tests/test_gate_sensitivity.py: on the bench workload the
    # accepted mask and final error are stable across keep in [0.90,0.99],
    # blowup in [1.2, 2.0], and radius in [0.02, 0.05] — the gates
    # separate clear improvements from clear regressions, they do not sit
    # on a knife edge.
    # Map-anchor acceptance margin (anchor_mode="map") on the
    # point-to-plane residual: the start is the corr-propagated chain
    # pose — often already at the optimum — so the gate must tolerate
    # the few-percent fluctuation of a near-tie refine (measured ~6% on
    # an already-anchored start) and only reject clear worsening; a
    # genuinely misaligned accept would blow the residual far past 1.2x
    # (and the point-rmse blowup guard still applies). The chain
    # refine's accept_margin=0.75 would reject every already-good frame.
    map_accept_margin: float = 1.2
    gate_inlier_keep: float = 0.95   # refined pose must keep >= 95% of
                                     # its matched inliers (churn slack)
    gate_rmse_blowup: float = 1.5    # point-rmse guard against in-plane
                                     # slip where plane residuals are blind
    gate_radius: float = 0.03        # inlier radius for the gate stats [m]
    # Annealed stage schedule: wide correspondence cap + loose Huber first
    # (pulls in starts the coarse stages left several cm off), then tight
    # (converges on the unbiased point-to-plane optimum). Each stage is a
    # full icp_align; the acceptance gate wraps the whole schedule.
    stages: tuple = (
        ICPConfig(
            max_iterations=4,
            max_correspondence_distance=0.4,
            transformation_epsilon=1e-12,
            euclidean_fitness_epsilon=1e-12,
            mse_threshold_absolute=1e-16,
            variant="point_to_plane",
            huber_delta=0.05,
            compute_fitness=False,
        ),
        ICPConfig(
            max_iterations=6,
            max_correspondence_distance=0.1,
            transformation_epsilon=1e-12,
            euclidean_fitness_epsilon=1e-12,
            mse_threshold_absolute=1e-16,
            variant="point_to_plane",
            huber_delta=0.005,
            compute_fitness=False,
        ),
    )


@dataclasses.dataclass(frozen=True)
class RotationEstimatorConfig:
    """IMU complementary filter; alpha = 0.98
    (src/rotation_estimator.hpp:16)."""

    alpha: float = 0.98


@dataclasses.dataclass(frozen=True)
class TranslationEstimatorConfig:
    """Per-axis exhaustive grid search; 500 candidates starting at
    -max_iterations/200 stepping +0.01 (src/translation_estimator.hpp:37-42)."""

    max_iterations: int = 500
    step: float = 0.01


@dataclasses.dataclass(frozen=True)
class CaptureConfig:
    """Capture-loop behavior.

    Keep one frame every >= 2 s (src/capture.hpp:168-170). The center crop
    keeps the middle 3/5 x 3/5 of the frame (src/capture.hpp:79-88). v2
    capture (``--capture``) keeps full resolution
    (src/capture_opencv.hpp:128-160).
    """

    throttle_ns: int = 2_000_000_000
    center_crop: bool = True
    depth_scale: float = 0.001   # RealSense Z16 depth unit (m per LSB)
    bgr_color: bool = True       # reference swizzles BGR->RGB (capture.hpp:99-101)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level bundle with the reference's registration defaults.

    ``default_rads`` is the static per-frame initial-guess y-rotation:
    -0.523599 rad = -30 deg (src/icp_edge_based_registration.hpp:135,
    src/main.cpp:215, README.md:39).
    """

    icp: ICPConfig = ICPConfig()
    ndt: NDTConfig = NDTConfig()
    edge: EdgeConfig = EdgeConfig()
    voxel: VoxelConfig = VoxelConfig()
    refine: RefineConfig = RefineConfig()
    # Guard the coarse stage: if the coarse (NDT/ICP) output scores worse
    # than the initial guess under the capped NN metric, keep the guess.
    # The reference trusts its coarse stage unconditionally; at NDT's 1 m
    # resolution the score optimum can sit several cm from a good IMU /
    # static guess, and the loose fine ICP cannot recover (its
    # max_correspondence_distance is 1 cm). 0 disables (the default:
    # reference-parity behavior).
    coarse_guard_cap: float = 0.0
    # Fuse phase 2's sequential frame chain into one compiled lax.scan
    # (single device dispatch for the whole registration). Semantically
    # identical to the per-frame loop; disable to step frames from Python.
    use_scan: bool = True
    # Constant-velocity warm start for the coarse stage: predict each
    # pair's transform as (previous achieved transform) o (raw guess
    # increment) o (carried local correction). Consecutive pairs of a
    # smooth trajectory share their per-frame motion, so Newton starts
    # inside its terminal basin — and unlike a global-frame correction,
    # the LOCAL carry also captures per-frame translation the
    # static/IMU guesses ignore (the partial-overlap failure mode). Off
    # by default: the reference seeds every pair from the raw guess.
    coarse_warm_start: bool = False
    # Gated wide-cap rescue stage (no reference analog): after the fine
    # ICP, if the fraction of valid source points with a correspondence
    # inside the fine cap falls below ``rescue_inlier_frac``, the pose is
    # outside the fine stage's basin (measured signature of NDT local
    # optima under partial overlap: inlier fraction 0.09-0.29 vs 0.5+
    # when aligned). The rescue runs ``rescue_iterations`` point-to-point
    # ICP iterations at the wider ``rescue_cap`` and re-fines; the result
    # is kept only when it beats the un-rescued pose under the capped NN
    # metric (never-worsen). 0 disables (reference-parity behavior: a
    # coarse-stage local optimum is simply kept).
    rescue_inlier_frac: float = 0.0
    rescue_cap: float = 0.1
    rescue_iterations: int = 8
    rotation: RotationEstimatorConfig = RotationEstimatorConfig()
    translation: TranslationEstimatorConfig = TranslationEstimatorConfig()
    capture: CaptureConfig = CaptureConfig()
    default_rads: float = -0.523599
    dataset_dir: str = "dataset"

    @staticmethod
    def with_degrees(deg: float) -> "PipelineConfig":
        """Reference deg->rad conversion: (deg / 180) * pi (src/main.cpp:215)."""
        return PipelineConfig(default_rads=(deg / 180.0) * math.pi)
