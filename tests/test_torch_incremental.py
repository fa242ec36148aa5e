"""The port's ``IncrementalICP`` against the JAX package's, on 3
JAX-rendered 160x120 frames fed to both through ``cloud_from_numpy``:
both the scan path (block appends gated on the device) and the
``use_scan=False`` loop path (``merge_append`` after a host-side
convergence test), with and without the fitness sweep, and one case with
a 10 cm correspondence cap so that the fits really move. The config is
``PipelineConfig()`` (the incremental benchmark's) with the voxel source
capacity cut to 2048 so that the CPU sweeps stay small.

Tolerances: identical converged flags, states and iterations (one ICP
iteration per pair here: the reference's transformation epsilon of 1
stops every pair after its first fit); per-pair transforms within 1e-4
(f32 rigid fits from sums taken in another order); fitness within rtol
1e-3; the result cloud's ``valid`` mask identical and its xyz within
atol 1e-5 plus the displacement that the measured transform difference
explains, 3 max|dR| max|p| + max|dt| (under the 1 cm cap the fits agree
to 7e-7 and that term is below 1e-5; under the 10 cm cap they agree to
1.5e-5, which moves points 3 m away by about 1.2e-5)."""

import dataclasses

import numpy as np
import pytest

from rspc_tpu.capture.synthetic import SyntheticSequence as JSequence
from rspc_tpu.config import PipelineConfig as JPipelineConfig
from rspc_tpu.ops.deproject import Intrinsics as JIntrinsics
from rspc_tpu.registration.schemes import IncrementalICP as JIncrementalICP
from rspc_tpu_torch.interop import cloud_from_numpy, config_from_dict
from rspc_tpu_torch.registration.schemes import IncrementalICP

N, YAW, W, H = 3, -0.08, 160, 120
VOXEL_CAP = 2048
# (use_scan, compute_fitness, max_correspondence_distance)
CASES = [
    (True, True, 0.01),
    (True, False, 0.01),
    (False, True, 0.01),
    (False, False, 0.01),
    (True, True, 0.1),
]


@pytest.fixture(scope="module")
def frames():
    seq = JSequence(n_frames=N, yaw_step=YAW, intr=JIntrinsics.simple(W, H))
    return seq.clouds()


@pytest.fixture(scope="module", params=CASES,
                ids=[f"scan{int(a)}-fit{int(b)}-cap{c}" for a, b, c in CASES])
def runs(request, frames):
    use_scan, fitness, max_dist = request.param
    base = JPipelineConfig()
    cfg = dataclasses.replace(
        base,
        use_scan=use_scan,
        voxel=dataclasses.replace(base.voxel, max_points=VOXEL_CAP),
        icp=dataclasses.replace(base.icp, compute_fitness=fitness,
                                max_correspondence_distance=max_dist),
    )
    jscheme = JIncrementalICP(cfg)
    jresult = jscheme.registration(frames)
    port_frames = [
        cloud_from_numpy({k: np.asarray(getattr(c, k)) for k in ("xyz", "rgb", "valid")},
                         organized=True)
        for c in frames
    ]
    tscheme = IncrementalICP(config_from_dict(dataclasses.asdict(cfg)))
    tresult = tscheme.registration(port_frames)
    return request.param, jscheme, jresult, tscheme, tresult


def test_states_match_jax(runs):
    _, jscheme, _, tscheme, _ = runs
    assert len(tscheme.results) == len(jscheme.results) == N - 1
    for t, j in zip(tscheme.results, jscheme.results):
        assert bool(t.converged) == bool(j.converged)
        assert int(t.state) == int(j.state)
        assert int(t.iterations) == int(j.iterations)


def test_transforms_match_jax(runs):
    (_, _, max_dist), jscheme, _, tscheme, _ = runs
    for t, j in zip(tscheme.results, jscheme.results):
        got, want = t.transform.numpy(), np.asarray(j.transform)
        assert np.abs(got - want).max() <= 1e-4, np.abs(got - want).max()
    if max_dist > 0.01:  # the wide cap really moves the fits
        assert max(np.abs(np.asarray(j.transform) - np.eye(4)).max()
                   for j in jscheme.results) > 1e-2


def test_fitness_matches_jax(runs):
    (_, fitness, _), jscheme, _, tscheme, _ = runs
    for t, j in zip(tscheme.results, jscheme.results):
        if fitness:
            np.testing.assert_allclose(float(t.fitness), float(j.fitness), rtol=1e-3)
            assert int(t.n_correspondences) == int(j.n_correspondences)
        else:
            assert np.isnan(float(t.fitness)) and np.isnan(float(j.fitness))


def test_result_cloud_matches_jax(runs, frames):
    _, jscheme, jresult, tscheme, tresult = runs
    v = np.asarray(jresult.valid)
    np.testing.assert_array_equal(tresult.valid.numpy(), v)
    assert tresult.xyz.shape == jresult.xyz.shape == (N * W * H, 3)
    assert np.isfinite(tresult.xyz.numpy()).all()
    reach = max(np.abs(np.asarray(c.xyz)[np.asarray(c.valid)]).max() for c in frames)
    moved = max(
        3 * np.abs(d[:3, :3]).max() * reach + np.abs(d[:3, 3]).max()
        for d in (t.transform.numpy() - np.asarray(j.transform)
                  for t, j in zip(tscheme.results, jscheme.results))
    )
    np.testing.assert_allclose(tresult.xyz.numpy()[v], np.asarray(jresult.xyz)[v],
                               rtol=0, atol=1e-5 + moved)
