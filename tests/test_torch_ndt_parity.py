"""NDT's objective values and tests/test_parallel.py's cube case against the
JAX package (CPU).

The cube case: 1,024 points uniform in a 4 m cube, the source moved by a
0.05 rad yaw and a (0.02, 0, -0.01) shift, a 16^3 grid,
``transformation_epsilon`` 1e-4 (``torch_parallel_worker.py::ndt_case``).
Both packages run it on the JAX package's grid moments
(``interop.ndt_grid_from_numpy``), in the three modes: the gather path
(the default), the PCL-exact line search, and the compact-cell sweep with
every valid cell compacted (1,024 cells).

Its last Newton steps are decided below one ulp of the score (2.4e-4 at
2,049): the frozen line search keeps a step only when ``f_res < phi0``,
two values of one sum at two poses. The port once took ``phi0`` from the
``[0, 0]`` of a ``[10, N] @ [N, 10]`` product and ``f_res`` from a
``[4, N] @ [N, 4]`` one, three roundings of one sum with
``fixed_objective``'s, and stopped after 7 steps where the JAX package
takes 9, 5.4e-4 away. Every value is now the per-point channel's dot
with the basis' constant column (``registration/ndt.py::_value``), so
the three evaluations agree bit for bit (the second test).

Which rounding of that one sum meets the JAX package is itself a tie.
The forms tried, each the same in all three evaluations (steps, port
against JAX, on the CPU): ``expt.sum()``: gather 9/9, exact 6/6, sweep
9/10, and the 4-rank sharded run 8/9; the per-point channel summed by
``sum()``: the sweep 9/10 and the 2-rank sharded run 10/9; an f64 sum:
the gather path 10/9; the dot with the constant column (kept) and the
same as a matrix-vector product: all three modes and both sharded runs
equal. Before the repair the sweep took 7 steps against 10; the JAX
package's own gather and sweep paths disagree (9 and 10 steps).

Tolerances: iterations equal, transforms max-abs ``JAX_TOL["ndt"]``
(1e-4; measured 8.2e-8 gather, 6.0e-8 exact, 5.6e-8 sweep), scores rtol
1e-4 (the sweep's is one ulp off); the three value functions equal bit
for bit at three poses.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from rspc_tpu.cloud import Cloud as JCloud
from rspc_tpu.config import NDTConfig as JNDTConfig
from rspc_tpu.registration import ndt as jn
from rspc_tpu_torch.config import NDTConfig
from rspc_tpu_torch.interop import cloud_from_numpy, config_from_dict, ndt_grid_from_numpy
from rspc_tpu_torch.registration import ndt as tn

MODES = {"gather": {}, "exact": {"pcl_exact_line_search": True}, "sweep": {"sweep_cells": 1024}}
# identity, a pose near the cube's solution, and one off both
POSES = [np.zeros(6, np.float32),
         np.float32([-0.02, 0.0, 0.01, 0.0, -0.05, 0.0]),
         np.float32([0.05, -0.03, 0.02, 0.01, 0.03, -0.02])]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch CPU thread: the suite runs several worker processes on
    few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cube():
    """(source, target) xyz and the JAX package's grid of the target: the
    grid reads no mode, so one compile serves every case."""
    src, tgt = W.ndt_case("cube")
    return src, tgt, jn.build_ndt_grid(JCloud.from_numpy(tgt), JNDTConfig(**W.NDT_CFG["cube"]))


def _port(cube, mode):
    """(JAX config, port config, port source, port grid on the JAX
    package's moments)."""
    src, _, jgrid = cube
    jcfg = JNDTConfig(**W.NDT_CFG["cube"], **MODES[mode])
    cfg = config_from_dict(dataclasses.asdict(jcfg), NDTConfig)
    grid = ndt_grid_from_numpy(np.asarray(jgrid.moments), np.asarray(jgrid.origin), cfg)
    return jcfg, cfg, cloud_from_numpy(W._cloud(src)), grid


@pytest.mark.parametrize("mode", list(MODES))
def test_cube_matches_jax(cube, mode):
    jcfg, cfg, src, grid = _port(cube, mode)
    want = jn.ndt_align(JCloud.from_numpy(cube[0]), cube[2], jcfg)
    got = tn.ndt_align(src, grid, cfg)
    assert int(got.iterations) == int(want.iterations)
    err = np.abs(got.transform.numpy() - np.asarray(want.transform)).max()
    assert err <= W.JAX_TOL["ndt"], err
    np.testing.assert_allclose(float(got.score), float(want.score), rtol=1e-4)


@pytest.mark.parametrize("pose", range(len(POSES)))
@pytest.mark.parametrize("mode", ["gather", "sweep"])
def test_value_functions_agree_bit_for_bit(cube, mode, pose):
    """``fixed_objective``, ``fixed_value_grad`` and
    ``fixed_value_grad_hess`` give one value at one pose and
    neighbourhood, and ``objective`` the same."""
    _, cfg, src, grid = _port(cube, mode)
    objective, lookup, f_obj, f_vg, f_vgh = tn._make_objective(src, grid, cfg)
    p = torch.from_numpy(POSES[pose])
    frozen = lookup(p)
    assert float(frozen[2].sum()) > 0
    value = f_obj(p, *frozen)
    assert torch.equal(f_vg(p, *frozen)[0], value)
    assert torch.equal(f_vgh(p, *frozen)[0], value)
    assert torch.equal(objective(p), value)
