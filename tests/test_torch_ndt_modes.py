"""The port's two optional NDT modes and ``ndt_grid_add`` against the JAX
package (CPU): the dense compact-cell sweep (``sweep_cells > 0``), the
PCL-exact line search (``pcl_exact_line_search``), and adding a cloud to
a grid.

Inputs: the ``ndt_pair`` scene of tests/test_torch_voxel_icp_ndt.py
(1,000 source points against a 2,400-point wall-and-floor target, moved
by a known rigid transform) and tests/test_ndt.py's seed-6 scene for the
cell cap.

Tolerances, those of ``test_ndt_align_matches_jax``: transforms max-abs
1e-4, iterations within +-1, scores rtol 1e-4; the compacted cells'
coordinates and validity equal exactly (a stable sort), their means
atol 1e-5 and inverse covariances rtol 1e-3, atol 1e-2 (each package
finalizes the same moments with its own eigensolver, as in
``test_ndt_grid_matches``); the line search alone on one
analytic function: step rtol 1e-5 (f32 arithmetic in two packages);
grid moments rtol 1e-5, atol 1e-6 (as ``test_ndt_grid_matches``).
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.cloud import Cloud as JCloud
from rspc_tpu.config import NDTConfig as JNDTConfig
from rspc_tpu.registration import ndt as jn
from rspc_tpu_torch.config import NDTConfig
from rspc_tpu_torch.interop import cloud_from_numpy, config_from_dict, ndt_grid_from_numpy
from rspc_tpu_torch.registration import ndt as tn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_ndt import _scene  # noqa: E402
from test_torch_voxel_icp_ndt import _ndt_scene, _np  # noqa: E402

TOL_T, TOL_SCORE = 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch CPU thread: the suite runs several worker processes on
    few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ndt_pair():
    return _ndt_scene()


@pytest.fixture(scope="module")
def jax_grid(ndt_pair):
    """The JAX package's grid of the pair's target, built once: the grid
    reads neither ``neighborhood``, ``sweep_cells`` nor the line search,
    so every case below shares one compile of ``build_ndt_grid``."""
    return jn.build_ndt_grid(ndt_pair[1], JNDTConfig(dense_grid_dim=16))


def _both(js, jgrid, jcfg):
    """(JAX result, port result) of ``ndt_align`` on the same source and
    the JAX grid's moments."""
    want = jn.ndt_align(js, jgrid, jcfg)
    tcfg = config_from_dict(dataclasses.asdict(jcfg), NDTConfig)
    grid = ndt_grid_from_numpy(np.asarray(jgrid.moments), np.asarray(jgrid.origin), tcfg)
    return want, tn.ndt_align(cloud_from_numpy(_np(js)), grid, tcfg)


def _assert_close(want, got):
    err = np.abs(got.transform.numpy() - np.asarray(want.transform)).max()
    assert err <= TOL_T, err
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    np.testing.assert_allclose(float(got.score), float(want.score), rtol=TOL_SCORE)


@pytest.mark.parametrize("neighborhood", [27, 7, 1])
def test_dense_sweep_matches_jax(ndt_pair, jax_grid, neighborhood):
    js, jt, t_true = ndt_pair
    jcfg = JNDTConfig(dense_grid_dim=16, neighborhood=neighborhood, sweep_cells=256)
    jgrid = jax_grid
    assert int(np.asarray(jgrid.valid).sum()) < 256  # no cell dropped
    want, got = _both(js, jgrid, jcfg)
    _assert_close(want, got)
    if neighborhood != 1:
        assert np.abs(got.transform.numpy() - t_true).max() < 2e-2
    # the same masked sum as the gather path
    gather = tn.ndt_align(cloud_from_numpy(_np(js)), tn.build_ndt_grid(
        cloud_from_numpy(_np(jt)), dataclasses.replace(
            config_from_dict(dataclasses.asdict(jcfg), NDTConfig), sweep_cells=0)),
        dataclasses.replace(config_from_dict(dataclasses.asdict(jcfg), NDTConfig),
                            sweep_cells=0))
    assert np.abs(got.transform.numpy() - gather.transform.numpy()).max() <= TOL_T


def test_dense_sweep_cell_overflow_matches_jax():
    """tests/test_ndt.py's cap case, with a cap below the occupied count:
    both packages drop the same cells (valid cells in cell-index order,
    the rest cut), so the tables and the solve agree."""
    pts = _scene(seed=6)
    jcloud = JCloud.from_numpy(pts)
    jcfg = JNDTConfig(dense_grid_dim=16, max_iterations=6)
    jgrid = jn.build_ndt_grid(jcloud, jcfg)
    n_valid = int(np.asarray(jgrid.valid).sum())
    assert n_valid > 4
    jc = dataclasses.replace(jcfg, sweep_cells=n_valid // 2)
    tc = config_from_dict(dataclasses.asdict(jc), NDTConfig)
    grid = ndt_grid_from_numpy(np.asarray(jgrid.moments), np.asarray(jgrid.origin), tc)
    (w_mu, w_ic, w_valid, w_co), (mu, ic, valid, co) = (
        jn._compact_cells(jgrid, jc), tn._compact_cells(grid, tc))
    np.testing.assert_array_equal(co.numpy(), np.asarray(w_co))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(w_valid))
    assert valid.all() and len(valid) == n_valid // 2
    np.testing.assert_allclose(mu.numpy(), np.asarray(w_mu), atol=1e-5)
    np.testing.assert_allclose(ic.numpy(), np.asarray(w_ic), rtol=1e-3, atol=1e-2)
    _assert_close(*_both(jcloud, jgrid, jc))


@pytest.mark.parametrize("neighborhood,sweep_cells", [(27, 0), (7, 256)])
def test_exact_line_search_matches_jax(ndt_pair, jax_grid, neighborhood, sweep_cells):
    js, _, t_true = ndt_pair
    jcfg = JNDTConfig(dense_grid_dim=16, neighborhood=neighborhood, sweep_cells=sweep_cells,
                      pcl_exact_line_search=True)
    want, got = _both(js, jax_grid, jcfg)
    _assert_close(want, got)
    assert np.abs(got.transform.numpy() - t_true).max() < 2e-2


def _quartic(xp):
    """f(q) = sum((q - c)^4) + 0.5 |q|^2 and its gradient, in numpy or
    torch (``xp``)."""
    c = np.float32([0.3, -0.2, 0.5, 0.1, -0.4, 0.25])

    def vg(q):
        d = q - (jnp.asarray(c) if xp is jnp else torch.from_numpy(c))
        return (d ** 4).sum() + 0.5 * (q * q).sum(), 4 * d ** 3 + q
    return vg


@pytest.mark.parametrize("step_init", [2.0, 9.0, 30.0])
def test_more_thuente_exact_matches_jax(step_init):
    """The line search alone on a quartic, from first steps past the
    minimum by more and more (2, 3 and 4 trials: the psi -> phi switch
    and the interval cases)."""
    cfg = JNDTConfig(transformation_epsilon=1e-4)
    tcfg = config_from_dict(dataclasses.asdict(cfg), NDTConfig)
    p = np.float32([0.0, 0.1, -0.1, 0.2, 0.0, -0.3])
    direction = np.float32([1.0, -0.5, 2.0, 0.3, -1.0, 0.7])
    direction /= np.linalg.norm(direction)
    jvg, tvg = _quartic(jnp), _quartic(torch)
    f0, g0 = jvg(jnp.asarray(p))
    want, wdir = jn._more_thuente_exact(jvg, jnp.asarray(p), jnp.asarray(direction), f0, g0,
                                        jnp.float32(step_init), 40.0, cfg)
    tf0, tg0 = tvg(torch.from_numpy(p))
    got, gdir = tn._more_thuente_exact(tvg, torch.from_numpy(p), torch.from_numpy(direction),
                                       tf0, tg0, torch.tensor(step_init), 40.0, tcfg)
    np.testing.assert_array_equal(gdir.numpy(), np.asarray(wdir))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(got) > 0


def test_ndt_grid_add_matches_jax(ndt_pair, jax_grid):
    js, jt, _ = ndt_pair
    jcfg = JNDTConfig(dense_grid_dim=16)
    tcfg = config_from_dict(dataclasses.asdict(jcfg), NDTConfig)
    want = jn.ndt_grid_add(jax_grid, js, jcfg)
    got = tn.ndt_grid_add(tn.build_ndt_grid(cloud_from_numpy(_np(jt)), tcfg),
                          cloud_from_numpy(_np(js)), tcfg)
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    np.testing.assert_allclose(got.moments.numpy(), np.asarray(want.moments),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), atol=1e-5)
    assert float(got.moments[:, 0].sum()) == 2400 + 1000  # both clouds, every point
