"""Shared pipeline presets (port of ``rspc_tpu/presets.py``).

``north_star_config()`` is the configuration of the benchmark workload:
10 synthetic 640x480 frames through ``NDTEdgeBasedRegistration``. The
rationale of each knob is recorded beside the JAX package's copy; the
two must stay equal (``tests/test_torch_config.py``). ``robust_config``
is not ported yet (ROADMAP.md Queue A).
"""

from __future__ import annotations

from rspc_tpu_torch.config import (
    EdgeConfig,
    ICPConfig,
    NDTConfig,
    PipelineConfig,
    RefineConfig,
    VoxelConfig,
)


def _anchor_stage(max_correspondence_distance: float, huber_delta: float):
    return ICPConfig(
        max_iterations=3,
        max_correspondence_distance=max_correspondence_distance,
        transformation_epsilon=1e-12,
        euclidean_fitness_epsilon=1e-12,
        mse_threshold_absolute=1e-16,
        variant="point_to_plane",
        huber_delta=huber_delta,
        compute_fitness=False,
        use_pallas=False,
        target_chunk=16384,
    )


def north_star_config() -> PipelineConfig:
    """Reference algorithmic defaults with the capacity/accuracy knobs
    sized for the 10-frame 640x480 workload."""
    return PipelineConfig(
        icp=ICPConfig(target_chunk=4096, max_source_points=8192),
        ndt=NDTConfig(
            neighborhood=7, max_source_points=2048, transformation_epsilon=0.025,
        ),
        edge=EdgeConfig(max_edge_points=16384, edge_types=("rgb_canny",)),
        voxel=VoxelConfig(leaf_size=0.01, max_points=10240),
        refine=RefineConfig(
            enabled=True, leaf_size=0.04, max_points=10240, decimate=2,
            normal_purity=0.995, chain=False, anchor_to_first=True,
            anchor_max_points=4096,
            anchor_stages=(_anchor_stage(0.05, 0.003), _anchor_stage(0.02, 0.001)),
        ),
        coarse_guard_cap=0.1,
    )
