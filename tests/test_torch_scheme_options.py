"""NDT's opt-in modes and the robust options through the port's
``NDTEdgeBasedRegistration`` (CPU), on the 3-frame 80x60 sequence and
``_small_config()`` of tests/test_pipeline.py.

Each option set is one case, in a file of its own so that ``--dist
loadfile`` gives these runs a worker beside tests/test_torch_edge_schemes.py.
tests/test_torch_ndt_modes.py and tests/test_torch_robust*.py hold the
same options against the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rspc_tpu.capture.synthetic import SyntheticSequence
from rspc_tpu.config import EdgeConfig, ICPConfig, NDTConfig, PipelineConfig, VoxelConfig
from rspc_tpu.ops.deproject import Intrinsics
from rspc_tpu_torch.interop import cloud_from_numpy, config_from_dict
from rspc_tpu_torch.registration import schemes as ts


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores, where torch's spinning
    intra-op threads slow every worker down by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


W, H, N, YAW = 80, 60, 3, -0.07


def _small_config():
    """tests/test_pipeline.py's ``_small_config``, as the port's config."""
    return config_from_dict(dataclasses.asdict(PipelineConfig(
        icp=ICPConfig(
            max_iterations=30,
            transformation_epsilon=1e-8,
            euclidean_fitness_epsilon=1e-12,
            max_correspondence_distance=0.25,
            target_chunk=512,
        ),
        ndt=NDTConfig(dense_grid_dim=16),
        edge=EdgeConfig(max_edge_points=2048),
        voxel=VoxelConfig(leaf_size=0.05, max_points=2048),
    )))


def _options(base):
    r = dataclasses.replace
    return {
        "exact": r(base, ndt=r(base.ndt, pcl_exact_line_search=True)),
        "sweep": r(base, ndt=r(base.ndt, sweep_cells=64)),
        "auto sweep 27": r(base, ndt=r(base.ndt, neighborhood=27, sweep_cells=-1)),
        "auto 7": r(base, ndt=r(base.ndt, neighborhood=7, sweep_cells=-1)),
        "robust": r(base, edge=r(base.edge, carry_cgrad=True), coarse_warm_start=True,
                    rescue_inlier_frac=0.3,
                    refine=r(base.refine, enabled=True, anchor_to_first=True,
                             anchor_mode="map", pose_graph=True, color=True)),
    }


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(n_frames=N, yaw_step=YAW, intr=Intrinsics.simple(W, H))
    return [cloud_from_numpy({k: np.asarray(getattr(c, k)) for k in ("xyz", "rgb", "valid")},
                             organized=True) for c in seq.clouds()]


@pytest.mark.parametrize("name", ["exact", "sweep", "auto sweep 27", "auto 7", "robust"])
def test_unported_options_raise(frames, name):
    """The options the port used to refuse (with ``NotImplementedError``
    naming ROADMAP.md) now run through the scheme: NDT's PCL-exact line
    search and its compact-cell sweep (a positive ``sweep_cells``, and -1
    at the 27-cell neighbourhood, where it resolves to 512 cells), beside
    -1 at the 7-cell one (the exact path) and the robust options. Each
    gives finite totals and a finite global cloud.
    tests/test_torch_ndt_modes.py (the sweep also against the gather
    path, per align) and tests/test_torch_robust*.py hold them against
    the JAX package."""
    scheme = ts.NDTEdgeBasedRegistration(config=_options(_small_config())[name])
    assert torch.isfinite(scheme.registration(frames).xyz).all(), name
    assert scheme.total_transforms.shape == (N - 1, 4, 4), name
    assert torch.isfinite(scheme.total_transforms).all(), name
