"""The port's sharded ICP and sharded and batched chains against the JAX
package's, computed live on the CPU.

One module fixture makes the inputs with the JAX package (the 80x60
frames and their phase-1 edge clouds; ``torch_parallel_jax.py``), starts
4 gloo ranks running ``torch_parallel_worker.py ... jax`` (the same
meshes as tests/test_torch_parallel.py: 2 x 2 and 4 ``points``), and,
while they run, runs the JAX package's sharded programs on its 8 virtual
CPU devices and its single-device ones on the same inputs (about 110 s
of compiles, so these comparisons have a file of their own).

Tolerances (``W.JAX_TOL``): the port's single-rank tolerance of the same
function against the JAX package: ICP transforms 1e-4
(tests/test_torch_voxel_icp_ndt.py), chain totals 5e-4 with the same
convergence and anchor flags, global points within 5e-3
(tests/test_torch_slice.py). The chains run on the JAX package's phase-1
edge clouds, swapped into the port's phase 1 as
tests/test_torch_robust_paths.py does: the two Canny implementations
break exact NMS ties differently (about ten edge pixels of these 80x60
frames), which moves the coarse ICP batch's totals by 1.5e-3 on each
package's own phase 1.
"""

import numpy as np
import pytest

import torch_parallel_jax as J
import torch_parallel_worker as W
from torch_parallel_worker import JAX_TOL, assert_same, max_err

RANK_TIMEOUT_S = 300
COLLECTIVE = ([f"icp {c} {m}" for c in W.ICP_CFG for m in ("points4", "2x2")]
              + [f"batched icp {v} 2x2" for v in ("p2p", "p2l")]
              + ["points chain points4 jax edges", "batched 2x2 jax edges"])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(each rank's ``{job: result}``, the JAX package's results), the JAX
    side computed while the ranks run."""
    inputs = J.inputs(edges=True)
    started = W.start(tmp_path_factory.mktemp("gloo"), inputs, "jax", RANK_TIMEOUT_S)
    try:
        jax_side = {**J.icp_sharded_results(), **J.icp_single_results(),
                    **J.chain_results(inputs)}
    finally:
        ranks = W.collect(started)
    return ranks, jax_side


@pytest.fixture(scope="module")
def ranks(both):
    return both[0]


@pytest.fixture(scope="module")
def jax_side(both):
    return both[1]


@pytest.mark.parametrize("job", COLLECTIVE)
def test_every_rank_holds_the_same_result(ranks, job):
    for r in range(1, W.WORLD):
        assert_same(ranks[r][job], ranks[0][job])


@pytest.mark.parametrize("case", list(W.ICP_CFG))
@pytest.mark.parametrize("mesh", ["points4", "2x2"])
def test_sharded_icp_matches_jax(ranks, jax_side, case, mesh):
    """Against the JAX package's sharded solve on 8 devices and its
    single-device one."""
    got = ranks[0][f"icp {case} {mesh}"]
    for which in ("sharded", "single"):
        assert max_err(got["transform"], jax_side[f"icp/{case}/{which}/transform"]) <= JAX_TOL["icp"]
    assert bool(got["converged"]) == bool(jax_side[f"icp/{case}/sharded/converged"])
    # fitness at a near-exact fit is f32 noise (~1e-14): an absolute bound
    np.testing.assert_allclose(got["fitness"], jax_side[f"icp/{case}/sharded/fitness"],
                               rtol=1e-3, atol=1e-10)


@pytest.mark.parametrize("variant", ["p2p", "p2l"])
def test_batched_sharded_icp_matches_jax(ranks, jax_side, variant):
    """Against the JAX package's batch on a 2 x 4 mesh."""
    got = ranks[0][f"batched icp {variant} 2x2"]
    assert got["transform"].shape == (2, 4, 4)
    assert max_err(got["transform"], jax_side[f"batched_icp/{variant}/transform"]) <= JAX_TOL["icp"]
    np.testing.assert_array_equal(got["converged"], jax_side[f"batched_icp/{variant}/converged"])


def test_points_sharded_chain_matches_jax(ranks, jax_side):
    """The robust chain (warm start, guard, rescue, map anchor), against
    the JAX package's points-sharded chain on 8 devices and its
    single-device program."""
    got = ranks[0]["points chain points4 jax edges"]
    for which in ("sharded", "single"):
        assert max_err(got["totals"], jax_side[f"points_chain/{which}/totals"]) <= JAX_TOL["chain"]
        np.testing.assert_array_equal(got["converged"],
                                      jax_side[f"points_chain/{which}/converged"])
    np.testing.assert_array_equal(got["anchor_accepted"],
                                  jax_side["points_chain/sharded/anchor_accepted"])


def test_batched_registration_matches_jax(ranks, jax_side):
    """The unsharded batch, NDT (with the global clouds) and ICP coarse
    stages."""
    got = ranks[0]["batched none jax edges ndt"]
    assert got["totals"].shape == (2, W.N_FRAMES - 1, 4, 4)
    assert max_err(got["totals"], jax_side["batched/ndt/totals"]) <= JAX_TOL["chain"]
    for k in ("converged", "anchor_accepted"):
        np.testing.assert_array_equal(got[k], jax_side[f"batched/ndt/{k}"])
    np.testing.assert_allclose(got["fitness"], jax_side["batched/ndt/fitness"], rtol=1e-3)
    v = jax_side["batched/ndt/global_valid"]
    np.testing.assert_array_equal(got["global"]["valid"], v)
    assert max_err(got["global"]["xyz"][v], jax_side["batched/ndt/global_xyz"][v]) <= JAX_TOL["global"]
    icp = ranks[0]["batched none jax edges icp"]
    assert max_err(icp["totals"], jax_side["batched/icp/totals"]) <= JAX_TOL["chain"]
    np.testing.assert_array_equal(icp["converged"], jax_side["batched/icp/converged"])
    assert "global" not in icp


def test_data_sharded_batch_matches_jax(ranks, jax_side):
    """Against the JAX package's data-sharded batch on a 2 x 4 mesh."""
    got = ranks[0]["batched 2x2 jax edges"]
    assert max_err(got["totals"], jax_side["batched/data_mesh/totals"]) <= JAX_TOL["chain"]
    np.testing.assert_array_equal(got["converged"], jax_side["batched/data_mesh/converged"])
